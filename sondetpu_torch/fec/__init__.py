"""Device-side RS syndrome check (counterpart: ``sondetpu/fec/syndrome.py``).

The host FEC (``sondetpu.fec.rs``, ``crc``, ``gf256``) imports no jax and is
used from the JAX package directly."""
