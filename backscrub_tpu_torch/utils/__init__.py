"""Stage timing and the debug HUD (counterpart of ``backscrub_tpu/utils``)."""
