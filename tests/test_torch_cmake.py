"""The port's C ABI as a CMake package (``backscrub_tpu_torch/native/
CMakeLists.txt``): configured, built and installed into a temporary
prefix with the host's ``cmake`` and ``c++``, then found by a consumer of
a few lines (``find_package(BackscrubTpuTorch)``) that runs the C ABI on
the CPU (``BACKSCRUB_TORCH_DEVICE=cpu``) over the committed synthetic
segm_lite model.  Bar: its masks byte-equal to ``MaskGen.process_bytes``
on the same frames and within the tolerance invariant of the JAX
package's (at most FRAME_TOL of a frame's bytes differ), and the
installed demo runs."""

import os
import pathlib
import shutil
import site
import subprocess

import numpy as np
import pytest

from backscrub_tpu_torch.pipeline.maskgen import MaskGen

ROOT = pathlib.Path(__file__).resolve().parent.parent
LITE = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
W, H, FRAMES = 64, 48, 3
TIMEOUT = 300
FRAME_TOL = 0.02

CONSUMER_CMAKE = """cmake_minimum_required(VERSION 3.16)
project(bs_consumer CXX)
find_package(BackscrubTpuTorch 0.1 REQUIRED)
add_executable(bs_consumer consumer.cc)
target_link_libraries(bs_consumer PRIVATE BackscrubTpuTorch::backscrub)
"""

# argv: model W H frames in.bgr out.masks
CONSUMER_CC = r"""#include <cstdio>
#include <cstdlib>
#include <vector>
#include "backscrub.h"
int main(int argc, char** argv) {
  size_t w = atoi(argv[2]), h = atoi(argv[3]), n = atoi(argv[4]);
  void* ctx = bs_maskgen_new(argv[1], 1, w, h, nullptr, nullptr, nullptr, nullptr, nullptr);
  if (!ctx) return 2;
  std::vector<unsigned char> frame(w * h * 3), mask(w * h);
  FILE *in = fopen(argv[5], "rb"), *out = fopen(argv[6], "wb");
  for (size_t i = 0; i < n; ++i) {
    if (fread(frame.data(), 1, frame.size(), in) != frame.size()) return 3;
    if (!bs_maskgen_process(ctx, frame.data(), mask.data())) return 4;
    fwrite(mask.data(), 1, mask.size(), out);
  }
  fclose(in); fclose(out); bs_maskgen_delete(ctx);
  return 0;
}
"""


def _env():
    env = dict(os.environ, PYTHONPATH=":".join([str(ROOT)] + site.getsitepackages()),
               OMP_NUM_THREADS="2", BACKSCRUB_TORCH_DEVICE="cpu")
    return env


def _run(cmd, **kw):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT, **kw)
    assert r.returncode == 0, f"{' '.join(map(str, cmd))}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    return r


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    if shutil.which("cmake") is None or shutil.which("c++") is None:
        pytest.skip("needs cmake and a host C++ compiler")
    tmp = tmp_path_factory.mktemp("cmake_torch")
    pre, build = tmp / "prefix", tmp / "build"
    _run(["cmake", "-S", str(ROOT / "backscrub_tpu_torch" / "native"), "-B", str(build),
          f"-DCMAKE_INSTALL_PREFIX={pre}"])
    _run(["cmake", "--build", str(build), "-j", "2"])
    _run(["cmake", "--install", str(build)])
    return pre


def test_cmake_package_installs_every_file(prefix):
    want = ["lib/libbackscrub_torch.so", "lib/libbsio_torch.so", "bin/backscrub_native_torch",
            "include/backscrub.h", "lib/cmake/BackscrubTpuTorch/BackscrubTpuTorchConfig.cmake",
            "lib/cmake/BackscrubTpuTorch/BackscrubTpuTorchConfigVersion.cmake"]
    assert all((prefix / f).is_file() for f in want)
    assert (prefix / "include" / "backscrub.h").read_bytes() == \
        (ROOT / "native" / "backscrub.h").read_bytes()
    cfg = (prefix / want[4]).read_text()
    assert "BackscrubTpuTorch::backscrub" in cfg and "BackscrubTpuTorch::bsio" in cfg


def test_find_package_consumer_masks_equal_process_bytes(prefix, tmp_path):
    src, build = tmp_path / "consumer", tmp_path / "consumer_build"
    src.mkdir()
    (src / "CMakeLists.txt").write_text(CONSUMER_CMAKE)
    (src / "consumer.cc").write_text(CONSUMER_CC)
    _run(["cmake", "-S", str(src), "-B", str(build), f"-DCMAKE_PREFIX_PATH={prefix}"])
    _run(["cmake", "--build", str(build)])
    frames = np.random.default_rng(5).integers(0, 256, (FRAMES, H, W, 3), np.uint8)
    (tmp_path / "in.bgr").write_bytes(frames.tobytes())
    _run([str(build / "bs_consumer"), LITE, str(W), str(H), str(FRAMES),
          str(tmp_path / "in.bgr"), str(tmp_path / "out.masks")], env=_env())
    got = (tmp_path / "out.masks").read_bytes()
    mg = MaskGen(LITE, W, H, device="cpu")
    want = b"".join(mg.process_bytes(f.tobytes(), H, W) for f in frames)
    assert len(got) == FRAMES * H * W and got == want
    from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
    ref = JaxMaskGen(LITE, W, H)
    masks = np.frombuffer(got, np.uint8).reshape(FRAMES, H, W)
    for f, m in zip(frames, masks):
        jm = np.frombuffer(ref.process_bytes(f.tobytes(), H, W), np.uint8).reshape(H, W)
        assert float((m != jm).mean()) <= FRAME_TOL


def test_installed_demo_runs(prefix, tmp_path):
    out = tmp_path / "out.yuyv"
    _run([str(prefix / "bin" / "backscrub_native_torch"), "-m", LITE, "--cg", f"{W}x{H}",
          "-n", "2", "-v", str(out)], env=_env())
    assert out.stat().st_size == 2 * H * W * 2
