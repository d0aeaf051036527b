"""The wgmma GEMM tile of K2'' at one, three and six terms
(``csrc/gemm_wg.cuh``) on the CPU: what the host lays out and picks for it,
and the plain versions it is held to, against the JAX package.

- the W pieces that ``MegaTable`` lays out in the arena for each GEMM op
  of deeplab's continuation at "highest" (three pieces), "high" (two) and
  "default" (one), read back element by element by a plain reader of the
  layout, equal ``split_bf16(w, 3 | 2 | 1)`` at each of the frame's 15
  shapes;
- ``lay_wgmma`` and ``unlay_wgmma`` are inverse at ragged shapes and every
  width;
- every wgmma tile's shared memory, and the tables' at each precision, fit
  the 232,448 bytes a CTA may have;
- each GEMM op's width makes its phase one round over the 132 SMs, with the
  most CTAs that one round allows; ``gemm_config`` at each term count
  splits K on whole slices and keeps the grid to the SMs;
- the table walker (``walk_table``) at each precision equals its twin
  (``run_plain``);
- the six-, three- and one-term twins on the arena's pieces against the
  JAX package's dots at HIGHEST, HIGH (its flat kernel's hi/lo split) and
  DEFAULT (XLA on the CPU) at the 15 shapes.

The card's side (``bs_gemm``, ``bs_body_mega`` on these tables) is held in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from backscrub_tpu_torch.ops import megakernel as tmega
from backscrub_tpu_torch.ops.megakernel import MEGA_FIELDS, split_bf16, walk_table
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEEPLAB = str(ROOT / "tests" / "data" / "deeplab_synth_257.tflite")
_F = {f: i for i, f in enumerate(MEGA_FIELDS)}
L = 33 * 33
SMS = 132
# the deeplab frame's 15 1x1 shapes (co, ci) at L = 33 * 33
SHAPES = [(16, 96), (21, 256), (32, 96), (32, 192), (48, 192), (48, 288), (80, 288),
          (80, 480), (96, 16), (160, 480), (192, 32), (256, 160), (256, 512), (288, 48),
          (480, 80)]
PRECISIONS = {"highest": ("bf16x6", 6), "high": ("bf16x3", 3), "default": ("bf16", 1)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conts():
    """deeplab's continuation plan at each of PRECISIONS, 640x480, on the
    CPU."""
    cfg = PipelineConfig(width=640, height=480)
    return {p: FramePipeline(DEEPLAB, cfg, device="cpu", precision=p).maskgen.edge.cont_plan
            for p in PRECISIONS}


def _gemm_rows(plan):
    """[(table row, its op)] of ``plan``'s GEMM ops."""
    mt = plan.mega
    return [(mt.table[i], m) for i, m in enumerate(mt.ops) if m["kind"] == "gemm"]


def _read_plain(arena: np.ndarray, off: int, n: int, co: int, ci: int, bn: int):
    """The ``n`` pieces (co, ci) of a GEMM op's W block at float offset
    ``off`` of ``arena``, each element read at the offset the layout gives
    it: co tile t, K slice s of 64, piece p, then the core matrix (8
    channels j, 8 of K kk) and its row and column, bf16 bits."""
    bits = arena[off:].view(np.uint16)
    o, k = np.meshgrid(np.arange(co), np.arange(ci), indexing="ij")
    slices = -(-ci // 64)
    out = []
    for p in range(n):
        idx = (((((o // bn) * slices + k // 64) * n + p) * (bn // 8) + (o % bn) // 8) * 8
               + (k % 64) // 8) * 64 + (o % 8) * 8 + k % 8
        out.append(torch.from_numpy(bits[idx].astype(np.int16)).view(torch.bfloat16))
    return out


@pytest.mark.parametrize("co,ci", SHAPES)
@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_arena_w_pieces_are_the_split(conts, precision, co, ci):
    """The arena's laid-out W of the GEMM op of shape (co, ci), read by the
    plain reader, is ``split_bf16(w, 3)`` at "highest", ``split_bf16(w)``
    at "high" and ``split_bf16(w, 1)`` at "default" (zero padding left
    out), and ``unlay_wgmma`` reads the same; the row keeps no second or
    third weight offset."""
    dots, terms = PRECISIONS[precision]
    plan = conts[precision]
    assert plan.dots == dots
    row, m = next((r, m) for r, m in _gemm_rows(plan) if (r[_F["co"]], r[_F["c"]]) == (co, ci))
    assert row[_F["w1"]] == row[_F["w2"]] == 0
    n, bn = tmega.GEMM_PIECES[terms], tmega._WG_TILES[row[_F["tile"]]]
    w = torch.from_numpy(np.asarray(plan.weights[m["w"]], np.float32))
    want = [t[:, :ci] for t in split_bf16(w, n)]
    got = _read_plain(plan.mega.arena, int(row[_F["w"]]), n, co, ci, bn)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ar = torch.from_numpy(plan.mega.arena)
    back = tmega.unlay_wgmma(ar[int(row[_F["w"]]):].view(torch.bfloat16), n, co, ci, bn)
    assert all(torch.equal(a, b) for a, b in zip(back, want))


@pytest.mark.parametrize("co,ci", [(7, 5), (33, 100), (130, 13), (16, 64), (81, 129)])
def test_lay_and_unlay_are_inverse(co, ci):
    """``unlay_wgmma`` gives back the pieces ``lay_wgmma`` laid out, at every
    width and each piece count; the block is the tile's padded size and
    zero in its padding."""
    w = torch.from_numpy(np.random.default_rng(co + ci).standard_normal((co, ci))
                         .astype(np.float32))
    for n in (1, 2, 3):
        pieces = split_bf16(w, n)
        for bn in tmega._WG_TILES:
            blk = tmega.lay_wgmma(pieces, bn)
            cp, kq = co + (-co % bn), -(-ci // 64) * 64
            assert blk.dtype == torch.bfloat16 and blk.numel() == n * cp * kq
            back = tmega.unlay_wgmma(blk, n, co, ci, bn)
            assert all(torch.equal(a, b[:, :ci]) for a, b in zip(back, pieces))
            assert int((blk != 0).sum()) == sum(int((t != 0).sum()) for t in pieces)


@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_table_and_tile_shared_memory_fit(conts, precision):
    """Every wgmma tile's ring at each term count, with the table, and the
    continuation's whole need at each precision fit a CTA's 232,448 bytes;
    the table reserves the ring of its widest GEMM tile."""
    for terms in (1, 3, 6):
        for bn in tmega._WG_TILES:
            assert tmega._wg_smem_bytes(bn, terms) + conts[precision].mega.table.nbytes \
                <= tmega._MAX_SMEM
    mt = conts[precision].mega
    terms = PRECISIONS[precision][1]
    rings = [tmega._wg_smem_bytes(tmega._WG_TILES[r[_F["tile"]]], terms)
             for r, _ in _gemm_rows(conts[precision])]
    assert mt.table.nbytes + max(rings) <= mt.smem_bytes <= tmega._MAX_SMEM
    assert tmega._wg_smem_bytes(80, 6) == 144536 and tmega._wg_smem_bytes(16, 1) == 58520
    assert tmega._wg_smem_bytes(16, 3) == 64664 and tmega._wg_smem_bytes(80, 3) == 113816


@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_gemm_tiles_fill_one_round(conts, precision):
    """Each GEMM op's width gives at most 132 CTAs (64 positions by the
    width), and the next narrower width would need a second round; 29 ops
    over the 15 shapes."""
    rows = _gemm_rows(conts[precision])
    assert len(rows) == 29 and len({(r[_F["co"]], r[_F["c"]]) for r, _ in rows}) == 15
    for r, _ in rows:
        co, n, tile = int(r[_F["co"]]), int(r[_F["n"]]), int(r[_F["tile"]])
        assert n == L
        ctas = [-(-co // bn) * -(-n // 64) for bn in tmega._WG_TILES]
        assert ctas[tile] <= SMS and (tile == 0 or ctas[tile - 1] > SMS)


@pytest.mark.parametrize("co,ci", SHAPES)
@pytest.mark.parametrize("terms", [1, 3, 6])
def test_gemm_config_of_the_wgmma_tile(co, ci, terms):
    """``bs_gemm``'s config at each term count: K split only where it is
    deep (ci >= 256), on whole 64-deep slices that cover it, the grid
    within the SMs; the table's width but for a deep K at three terms."""
    tile, split, kchunk = tmega.gemm_config(co, ci, L, SMS, terms)
    assert tile == tmega._wg_tile(co, L) or (terms == 3 and ci >= 256)
    grid = -(-co // tmega._WG_TILES[tile]) * -(-L // 64)
    assert kchunk % 64 == 0 and (split - 1) * kchunk < ci <= split * kchunk
    assert split == 1 or (ci >= 256 and grid * split <= SMS)


@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_table_walker_matches_its_twin(conts, precision):
    """The continuation's table at "highest" (29 six-term GEMM rows on their
    laid-out pieces), "high" (three-term rows) and "default" (one-term
    rows), walked phase by phase, within 1e-5 of ``run_plain`` in the
    table's dots."""
    plan = conts[precision]
    x = torch.from_numpy((np.random.default_rng(5).standard_normal((16, L)) * 0.5)
                         .astype(np.float32))
    with torch.no_grad():
        got = walk_table(plan, x)
        want = plan.run_plain(x, gemm=plan.dots)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("co,ci", SHAPES)
def test_twins_on_arena_pieces_match_jax(conts, co, ci):
    """The six-term twin on the "highest" arena's pieces against the JAX
    package's dot at HIGHEST, the three-term twin on the "high" arena's
    pieces against the JAX flat kernel's HIGH split (hi.hi + hi.lo + lo.hi,
    three DEFAULT dots of bf16 pieces), and the one-term twin on the
    "default" arena's piece against its dot at DEFAULT on bf16-rounded
    operands (XLA on the CPU), at each of the 15 shapes."""
    rng = np.random.default_rng(co * 1000 + ci)
    x = rng.uniform(0, 2, (ci, L)).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    for precision, (_, terms) in PRECISIONS.items():
        plan = conts[precision]
        row, m = next((r, m) for r, m in _gemm_rows(plan)
                      if (r[_F["co"]], r[_F["c"]]) == (co, ci))
        n, bn = tmega.GEMM_PIECES[terms], tmega._WG_TILES[row[_F["tile"]]]
        ar = torch.from_numpy(plan.mega.arena)
        pieces = tmega.unlay_wgmma(ar[int(row[_F["w"]]):].view(torch.bfloat16), n, co, ci, bn)
        w = np.asarray(plan.weights[m["w"]], np.float32)
        xt, bt = torch.from_numpy(x), torch.from_numpy(b)
        if terms == 6:
            got = tmega.conv1x1_bf16x6_plain(None, bt, xt, split=pieces).numpy()
            ref = np.asarray(jnp.dot(jnp.asarray(w), jnp.asarray(x),
                                     precision=jax.lax.Precision.HIGHEST)) + b[:, None]
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        elif terms == 3:
            got = tmega.conv1x1_bf16x3_plain(None, bt, xt, split=pieces).numpy()
            (wh, wl), (xh, xl) = (
                (a.astype(jnp.bfloat16), (a - a.astype(jnp.bfloat16).astype(jnp.float32))
                 .astype(jnp.bfloat16)) for a in (jnp.asarray(w), jnp.asarray(x)))

            def d(u, v):
                return jax.lax.dot_general(u, v, (((1,), (0,)), ((), ())),
                                           precision=jax.lax.Precision.DEFAULT,
                                           preferred_element_type=jnp.float32)
            ref = np.asarray(d(wh, xh) + d(wh, xl) + d(wl, xh)) + b[:, None]
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        else:
            got = (pieces[0].float() @ tmega.bf16_round(xt) + bt[:, None]).numpy()
            wb, xb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (w, x))
            ref = np.asarray(jnp.dot(wb, xb, preferred_element_type=jnp.float32,
                                     precision=jax.lax.Precision.DEFAULT)) + b[:, None]
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
            assert torch.equal(pieces[0], split_bf16(torch.from_numpy(w), 1)[0][:, :ci])


def test_ablation_anchors_hold_in_the_tile():
    """tools/gemm_ablation.py's edits find the text they replace in
    gemm_wg.cuh, each once (the products' call may recur)."""
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    import gemm_ablation
    src = (ROOT / "backscrub_tpu_torch" / "csrc" / "gemm_wg.cuh").read_text()
    for name, edits in gemm_ablation.ABLATIONS:
        for old, _ in edits:
            assert old in src, (name, old)
            assert src.count(old) == 1 or old == "wg::mma<BN>(", (name, old)
