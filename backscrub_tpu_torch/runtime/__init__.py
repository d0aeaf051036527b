"""The serving loop (counterpart of ``backscrub_tpu/runtime``)."""
