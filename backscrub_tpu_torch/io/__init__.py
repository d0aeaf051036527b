"""Host I/O: capture sources, sinks, background sources, pinned staging
and the V4L2 shim's bindings (counterpart of ``backscrub_tpu/io``)."""
