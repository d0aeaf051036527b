"""Print each kernel's registers, shared memory and spills as ptxas reports
them, for the port's CUDA sources, on a machine with the CUDA toolkit.

Compiles each named source of ``backscrub_tpu_torch/csrc`` (all of them by
default) with the flags of ``backscrub_tpu_torch/_build.py`` and
``-Xptxas -v``, one ``nvcc`` process a source, all started together, into
a temporary directory, and prints one line a kernel: its demangled name
(as ``cu++filt`` gives it, where the toolkit has it), registers, spill
stores and loads, stack frame and static shared memory; then every ptxas
warning and performance note (a wgmma that ptxas serialized, a spill) as
it was printed.
Exits 1 if a source does not compile.

Usage (from the repository root)::

    python tools/ptxas_usage.py [body_mega.cu] [body_flat.cu] [--grep NAME]
"""

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def demangle(names):
    """``names`` demangled by cu++filt (unchanged where it is missing)."""
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not names or not os.path.exists(tool):
        return list(names)
    r = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    out = r.stdout.splitlines()
    return out if r.returncode == 0 and len(out) == len(names) else list(names)


def parse(text):
    """[(mangled name, {registers, spill_stores, spill_loads, stack, smem})]
    and the warning lines of ptxas's -v output ``text``."""
    rows, cur, warnings = [], None, []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1)}
            rows.append(cur)
            continue
        if "warning" in line.lower() or "Performance Loss" in line:
            warnings.append(line.strip())
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return rows, warnings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--grep", default="", help="only kernels whose name holds this")
    a = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from backscrub_tpu_torch import _build
    srcs = [os.path.join(_build.SRC_DIR, s) for s in a.sources] or _build._sources()
    nvcc = _build._nvcc()
    failed = False
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, _build.ARCH, *_build.FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, os.path.basename(src) + ".o"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in srcs]
        for src, proc in procs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed = True
                print(f"{os.path.basename(src)}: nvcc failed ({proc.returncode})\n{out}")
                continue
            rows, warnings = parse(out)
            names = demangle([r["name"] for r in rows])
            for r, name in zip(rows, names):
                if a.grep in name:
                    print(f"{os.path.basename(src)} {name}: {r.get('registers')} registers, "
                          f"spill stores {r.get('spill_stores')} B, loads "
                          f"{r.get('spill_loads')} B, stack {r.get('stack')} B, static smem "
                          f"{r.get('smem')} B")
            for w in warnings:
                print(f"{os.path.basename(src)} ptxas: {w}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
