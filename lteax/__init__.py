"""lteax — an LTE FDD PHY framework in JAX (XLA / Pallas).

Brand-new implementation of the capabilities of mgp25/OpenLTE's ``liblte_phy``
(reference: ``liblte/src/liblte_phy.cc``) plus the host-side stack codecs the
downlink scanner path needs (``liblte_rrc``/``liblte_mme``/``liblte_security``
subsets).  This is NOT a port: the dataplane is pure-functional, statically
shaped, batched, ``jit``-compiled JAX with a Pallas kernel for the turbo
decoder's hot loop, sharded over a ``jax.sharding.Mesh`` for multi-device
/ multi-host scaling.

Package layout (see SURVEY.md §7):
  phy/      PhyConfig, 36.211/212/213 tables, sequences, OFDM, sync,
            channel estimation, modulation, FEC, physical channel codecs
  kernels/  turbo max-log-MAP half-iteration (GPU kernel + plain version),
            polyphase resampler
  shard/    mesh definitions, overlap-save halo exchange, sharded pipelines
  io/       IQ sample stream readers/writers
  stack/    host-side control-plane codecs (RRC MIB/SIBs, bands, security)
  apps/     file_gen / file_scan / scanner applications
  sim/      AWGN + fading channel simulators for tests/benches
"""

__version__ = "0.1.0"
