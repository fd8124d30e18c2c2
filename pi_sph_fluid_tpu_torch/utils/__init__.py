"""Measurement helpers (counterpart of `pi_sph_fluid_tpu/utils/`)."""
