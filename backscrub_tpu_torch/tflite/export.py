"""Write (fine-tuned) parameters back into a ``.tflite`` file (counterpart
of ``backscrub_tpu/tflite/export.py``).

After fine-tuning with :class:`backscrub_tpu_torch.train.trainer.Trainer`,
the updated weights are patched into a byte-for-byte copy of the original
model file (same graph, same shapes, new weights), loadable by TFLite, by
both packages and by the reference binary.  Payloads are fixed-size, so
each one is overwritten in place at the byte span the loader recorded
(``TensorIR.buffer_offset``/``buffer_size``): no ``flatbuffers`` package
is needed.  Each parameter is mapped back through the inverse of its
lowering's layout transform, into the subgraph that its
``CompiledModel.weight_meta`` entry names (WHILE/IF bodies own weights of
their own).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..graph.executor import CompiledModel
from .loader import load_tflite_bytes


def export_params_to_tflite(original_path: str, model: CompiledModel,
                            params: Dict[str, object], out_path: str) -> int:
    """Patch ``params`` (arrays or tensors under ``model``'s keys) into a
    copy of ``original_path``; returns the number of tensors written.

    f16-stored weights (the DEQUANTIZE models) are cast back to f16 (a
    precision-truncating cast after f32 training); int8 kernels with their
    ``__scale`` are dequantized first.  A tensor without storage of its own
    is skipped; a payload whose size differs from the file's raises.
    """
    with open(original_path, "rb") as f:
        buf = bytearray(f.read())
    loaded = load_tflite_bytes(buf, original_path)
    files = loaded.subgraphs or [loaded]            # the tensors' spans, subgraph by subgraph
    graphs = model.graph.subgraphs or [model.graph]  # the folds' aliases
    host = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in params.items()}
    n = 0
    for key, meta in model.weight_meta.items():
        if key not in host:
            continue
        sub, idx = meta.get("subgraph", 0), meta["tensor_index"]
        # a folded dequant output -> its f16 storage, in the parameter's subgraph
        t = files[sub].tensors[graphs[sub].aliases.get(idx, idx)]
        if t.buffer_offset is None:
            continue
        arr = host[key]
        if arr.dtype == np.int8 and key + "__scale" in host:
            # runtime-quantized kernel: dequantize back to the file's dtype
            arr = arr.astype(np.float32) * host[key + "__scale"].astype(np.float32)
        if meta["inverse"] is not None:
            arr = meta["inverse"](arr)
        raw = np.ascontiguousarray(arr, dtype=meta["dtype"]).view(np.uint8).reshape(-1)
        if raw.size != t.buffer_size:
            raise ValueError(f"{key}: payload {raw.size}B != buffer {t.buffer_size}B")
        buf[t.buffer_offset:t.buffer_offset + raw.size] = raw.tobytes()
        n += 1
    with open(out_path, "wb") as f:
        f.write(bytes(buf))
    return n
