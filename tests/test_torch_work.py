"""Work counts, build keys and source-level contracts of the port's CUDA
kernels, on the CPU.

``work`` splits each kernel's operations into its matrix products and the
rest, which ``chip_smoke.py`` bounds at the tensor-core and the CUDA-core
rates; ``flops`` is their sum, the total the kernels were always counted
at. ``ops.build.source_digest`` is the key a built library is cached
under: it must change when a shared header changes. The GEMM's epilogue
codes that ``ops/vit_block.py`` passes must be the values of the enum in
``csrc/vit_block.cu``, the general scan's and the d_state=1 scan's
wrappers must size their buffers and grids with the kernels' own block
widths and chunks, the MAE and classification step profiles must name the
family of every kernel the ViT and Swin sub-layers launch, and the scans'
timing tools their kernels. The fused Mamba layer's backward likewise: its
wrapper's block, lane and chunk sizes are the kernel's, and its workspace
at vssm_tiny stage 0 stays under the 2.47 GB of carries it replaced; its
forward's chunk choice cuts L only where the grid would not fill the card,
into chunks its summaries kernel is built for.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

import torch

from medical_image_analysis_tpu_torch.ops import build
from medical_image_analysis_tpu_torch.ops import mamba_fused as mf
from medical_image_analysis_tpu_torch.ops import scan_n1 as sn
from medical_image_analysis_tpu_torch.ops import selective_scan_pallas as ssp
from medical_image_analysis_tpu_torch.ops import swin_block as sb
from medical_image_analysis_tpu_torch.ops import vit_block as vb

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "medical_image_analysis_tpu_torch" / "csrc"

# (B, L, d, heads): the mae_hd_1280 encoder and decoder, a ragged tiny one
VIT_WORK_SHAPES = [(16, 1401, 768, 12), (16, 6401, 512, 16), (3, 13, 64, 4)]


@pytest.mark.parametrize("b,l,d,heads", VIT_WORK_SHAPES,
                         ids=["encoder", "decoder", "tiny"])
@pytest.mark.parametrize("kind", ["attn_fwd", "mlp_fwd", "attn_bwd",
                                  "mlp_bwd"])
def test_vit_work_splits_the_total(kind, b, l, d, heads):
    """Products and the rest, each as counted from the shapes, adding up
    to the totals the sub-layers were counted at before the split."""
    rows, hidden, scores = b * l, 4 * d, b * heads * l * l
    products, other = {
        "attn_fwd": (2 * rows * d * 4 * d + 4 * rows * l * d, 4 * scores),
        "mlp_fwd": (4 * rows * d * hidden, 10 * rows * hidden),
        "attn_bwd": (2 * rows * d * 11 * d + 12 * b * l * l * d, 7 * scores),
        "mlp_bwd": (10 * rows * d * hidden, 20 * rows * hidden),
    }[kind]
    assert vb.work(kind, b, l, d, heads, hidden) == (products, other)
    assert vb.flops(kind, b, l, d, heads, hidden) == products + other


def test_vit_attn_bwd_work_at_the_mae_shapes():
    """The restated bounds: 580 GFLOP of products at the encoder, 4.62
    TFLOP at the decoder."""
    assert vb.work("attn_bwd", 16, 1401, 768, 12)[0] == 580_299_669_504
    assert vb.work("attn_bwd", 16, 6401, 512, 16)[0] == 4_618_440_507_392


@pytest.mark.parametrize("windows,d,heads", [(4096, 192, 6), (64, 1536, 48),
                                             (3, 32, 2)],
                         ids=["swin_large-s0", "swin_large-s3", "tiny"])
def test_swin_work_splits_the_total(windows, d, heads):
    rows = windows * 49
    products = 2 * rows * d * 4 * d + 4 * rows * 49 * d
    other = 6 * windows * heads * 49 * 49
    assert sb.work(windows, 49, d, heads) == (products, other)
    assert sb.flops(windows, 49, d, heads) == products + other


def test_build_key_follows_the_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes, or adding one, changes the
    source's build key; the key does not depend on anything else."""
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.source_digest("a")
    assert build.source_digest("a") == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = build.source_digest("a")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert build.source_digest("a") not in (first, second)
    (tmp_path / "other.cuh").unlink()
    assert build.source_digest("a") == second
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-I/x"))
    assert build.source_digest("a") != second


def _enum(src: str, name: str) -> dict:
    """{PYTHON_NAME: value} of ``enum <name> { kNameCamelCase = v, ... }``."""
    body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
    out = {}
    for camel, value in re.findall(rf"k{name}(\w+) = (\d+)", body):
        words = re.findall(r"[A-Z][a-z]*\d*", camel)
        out[f"{name.upper()}_" + "_".join(w.upper() for w in words)] = int(
            value)
    return out


@pytest.mark.parametrize("enum", ["Epi"])
def test_gemm_codes_match_the_kernel_enums(enum):
    """``EPI_*`` are the values of ``enum Epi``, name for name, with none
    missing on either side."""
    want = _enum((CSRC / "vit_block.cu").read_text(), enum)
    prefix = f"{enum.upper()}_"
    got = {k: getattr(vb, k) for k in dir(vb) if k.startswith(prefix)}
    assert want and got == want


@pytest.mark.parametrize("constant,attr", [("kThreads", "_THREADS"),
                                           ("kChunk", "_CHUNK"),
                                           ("kFwdBlocks", "_FWD_BLOCKS")])
def test_selective_scan_sizes_match_the_kernel(constant, attr):
    """``_THREADS`` (channels a block: ``dB_part``'s and ``dC_part``'s
    leading extent, and the forward's grid), ``_CHUNK`` (rows a carry:
    ``carries``' second extent) and ``_FWD_BLOCKS`` (the forward's cap of
    blocks an SM) are the values of ``csrc/selective_scan.cu``'s
    constants."""
    src = (CSRC / "selective_scan.cu").read_text()
    want = re.findall(rf"constexpr int {constant} = (\d+);", src)
    assert len(want) == 1 and int(want[0]) == getattr(ssp, attr)


@pytest.mark.parametrize("constant,attr", [("kThreads", "_THREADS"),
                                           ("kChunk", "_CHUNK"),
                                           ("kSub", "_PIECE"),
                                           ("kCarryThreads", "_CARRY_THREADS"),
                                           ("kFwdBlocks", "_FWD_BLOCKS")])
def test_scan_n1_sizes_match_the_kernel(constant, attr):
    """``_THREADS`` (channels a block: ``dxdbl_part``'s leading extent),
    ``_CHUNK`` (source rows a chunk of the backward and of the forward's
    cut regime: the weight-gradient partials' chunk extent), ``_PIECE``
    (rows a slot of the workspaces), ``_CARRY_THREADS`` (chains a block of
    the carry kernels, for the grid counts) and ``_FWD_BLOCKS`` (the
    forward scan's cap of resident blocks an SM) are the values of
    ``csrc/scan_n1.cu``'s constants."""
    src = (CSRC / "scan_n1.cu").read_text()
    want = re.findall(rf"constexpr int {constant} = (\d+);", src)
    assert len(want) == 1 and int(want[0]) == getattr(sn, attr)


@pytest.mark.parametrize("b,l,d", [(12, 3136, 256), (3, 1000, 70)])
def test_scan_n1_workspaces_are_chunked_as_the_kernel(b, l, d):
    """The backward's sums (P, H, G) and carries (h_in, g_in) have one
    entry a (direction, image, piece of a chunk, channel), as
    ``csrc/scan_n1.cu``'s layout comment gives them; the grid counts follow
    the same chunks."""
    sums, carries = sn._workspaces(torch.empty(0), b, l, d)
    chunks = -(-l // sn._CHUNK)
    slots = chunks * (sn._CHUNK // sn._PIECE)
    assert sums.shape == (3, 4, b, slots, d)
    assert carries.shape == (2, 4, b, slots, d)
    blocks = sn.bwd_grid_blocks(b, l, d)
    assert list(blocks) == list(sn.BWD_KERNELS)
    nblk = -(-d // sn._THREADS)
    assert blocks["scan_n1_bwd_grad_kernel"] == chunks * nblk * b * 2
    assert blocks["scan_n1_bwd_sums_kernel"] == chunks * nblk * b * 4
    # the forward's cut regime: (P, H) and h_in in the same slots
    sums, carries = sn._workspaces(torch.empty(0), b, l, d, (2, 1))
    assert sums.shape == (2, 4, b, slots, d)
    assert carries.shape == (1, 4, b, slots, d)
    assert sn.fwd_grid_blocks(b, l, d, sn._CHUNK) == dict(zip(
        sn.FWD_KERNELS, (blocks["scan_n1_bwd_grad_kernel"],
                         blocks["scan_n1_bwd_carry_kernel"],
                         blocks["scan_n1_bwd_grad_kernel"])))


# (B, L, D) of the forward's main-path calls: vssm1_base's stages at the
# training step's 12 images, the context tower's 36, validation's 4, and one
# image; and shapes of the card tests.
N1_FWD = ([(b, hw * hw, 2 * dim) for b in (12, 36, 4, 1)
           for hw, dim in ((56, 128), (28, 256), (14, 512), (7, 1024))]
          + [(5, 33, 24), (3, 1, 16), (2, 20, 70), (3, 1000, 70)])


@pytest.mark.parametrize("b,l,d", N1_FWD)
def test_scan_n1_fwd_chunk_is_l_or_the_built_chunk(b, l, d):
    """The forward's chunk is L (one pass of the scan kernel, no workspace)
    or ``_CHUNK`` rows, the chunk the summaries kernel is built for; L
    exactly where L is at most ``_ONE_PASS_ROWS`` or the one-pass grid
    gives each of the H100's 132 SMs a block: stages 2 and 3 at every
    batch, stages 0 and 1 at the context tower's 36 images and stage 1 at
    12; cut at stage 0 at up to 12 images and at stage 1 at 4. The grid
    counts follow the chunk."""
    chunk = sn.fwd_chunk(b, l, d)
    blocks = 2 * b * -(-d // sn._THREADS)
    assert chunk in (l, sn._CHUNK)
    assert (chunk == l) == (l <= sn._ONE_PASS_ROWS or blocks >= 132)
    if (l == 3136 and b <= 12) or (b, l) == (4, 784):
        assert chunk == sn._CHUNK
    if l <= 196 or b == 36 or (b, l) == (12, 784):
        assert chunk == l
    grid = sn.fwd_grid_blocks(b, l, d, chunk)
    assert list(grid) == list(sn.FWD_KERNELS)
    if chunk == l:
        assert grid == dict(zip(sn.FWD_KERNELS, (0, 0, blocks)))
    else:
        assert grid["scan_n1_fwd_kernel"] == -(-l // chunk) * blocks
        assert grid["scan_n1_fwd_sums_kernel"] == -(-l // chunk) * blocks


@pytest.mark.parametrize("constant,attr", [("kBwdThreads", "_BWD_THREADS"),
                                           ("kLanes", "_BWD_LANES"),
                                           ("kBwdChunk", "_BWD_CHUNK"),
                                           ("kCarryThreads", "_CARRY_THREADS")])
def test_mamba_bwd_sizes_match_the_kernel(constant, attr):
    """``_BWD_THREADS`` and ``_BWD_LANES`` (a block's threads and the lanes
    of a channel: ``dxdbl_part``'s channel-block extent), ``_BWD_CHUNK``
    (scan rows a slot of the workspaces) and ``_CARRY_THREADS`` (chains a
    block of the carry kernel, for ``bwd_grid_blocks``) are the values of
    ``csrc/mamba_fused.cu``'s constants."""
    src = (CSRC / "mamba_fused.cu").read_text()
    want = re.findall(rf"constexpr int {constant} = (\d+);", src)
    assert len(want) == 1 and int(want[0]) == getattr(mf, attr)


# (B, K, L, D, N, R): ARM-B at the training micro-batch, vssm_tiny stage 0
# at vssm_classify's batch, a ragged small one
MAMBA_BWD_SHAPES = [(6, 4, 197, 768, 16, 48), (128, 4, 3136, 192, 16, 6),
                    (3, 2, 70, 40, 4, 3)]


@pytest.mark.parametrize("b,k,l,d,n,r", MAMBA_BWD_SHAPES,
                         ids=["arm-b", "vssm-tiny-s0", "ragged"])
def test_mamba_bwd_workspaces_are_chunked_as_the_kernel(b, k, l, d, n, r):
    """The backward's summaries (S, H, G; the carries once its second
    kernel ran) and weight-gradient partials have one slot a (b*k, chunk
    of ``_BWD_CHUNK`` scan rows), as ``csrc/mamba_fused.cu``'s layout
    comment gives them; the grids follow the same chunks; and the whole
    workspace at vssm_tiny stage 0, B=128, is under the 2.47 GB of
    per-8-row carries it replaced."""
    w = mf._bwd_workspaces(torch.device("meta"), b * k, l, d, n, r)
    chunks = -(-l // mf._BWD_CHUNK)
    assert w["sums"].shape == (b * k, chunks, 1 + 2 * n, d)
    assert w["dA"].shape == (b * k, chunks, d, n)
    assert w["dD"].shape == w["ddb"].shape == (b * k, chunks, d)
    assert w["ddtw"].shape == (b * k, chunks, d, r)
    blocks = mf.bwd_grid_blocks(b, k, l, d, n)
    assert list(blocks) == list(mf.BWD_KERNELS)
    nblk = -(-d // (mf._BWD_THREADS // mf._BWD_LANES))
    assert blocks["mamba_scan_bwd_sums_kernel"] == chunks * nblk * b * k
    assert blocks["mamba_scan_bwd_grad_kernel"] == chunks * nblk * b * k
    assert blocks["mamba_scan_bwd_carry_kernel"] == -(
        -b * k * n * d // mf._CARRY_THREADS)
    if (l, d) == (3136, 192):
        nbytes = sum(t.numel() * 4 for t in w.values())
        old_carries = b * k * -(-l // 8) * n * d * 4
        assert old_carries == 2_466_250_752 and nbytes < 1.2e9


# (B, K, L, D): vssm_tiny's four stages at vssm_classify's B=128
VSSM_TINY_FWD = [(128, 4, 3136, 192), (128, 4, 784, 384), (128, 4, 196, 768),
                 (128, 4, 49, 1536)]
# ARM-B at serving (B=1), at the training micro-batch (B=6) and at
# validation's 12 and 4 images; stage 3's shape on each side of the
# threshold (the card tests' cases: 4 directions, and 2 at B=1); small
# ones
ARM_B_FWD = [(1, 4, 197, 768), (6, 4, 197, 768), (12, 4, 197, 768),
             (4, 4, 197, 768)]
OTHER_FWD = [(1, 4, 49, 1536), (1, 2, 49, 1536), (2, 4, 10, 8),
             (3, 2, 197, 70), (2, 4, 3136, 192), (1, 1, 5, 8),
             (2, 4, 197, 768)]


@pytest.mark.parametrize("b,k,l,d", VSSM_TINY_FWD + ARM_B_FWD + OTHER_FWD)
def test_mamba_fwd_chunk_is_l_or_a_built_chunk(b, k, l, d):
    """The forward's chunk is L (one kernel from zero, no workspace) or
    ``_FWD_CUT`` rows, a multiple of the 8-row sub-chunk under L that the
    summaries kernel is built for; L exactly where one chunk a direction gives each of the
    H100's 132 SMs a block: at vssm_tiny's stages at B=128, at ARM-B from
    2 images on (training's 6, validation's 4 and 12) and at stage 3's
    shape from B=1; cut at ARM-B's serving batch of 1 and at stage 3's
    shape with 2 directions. The grid counts follow the chunk."""
    chunk = mf.fwd_chunk(b, k, l, d)
    blocks = b * k * -(-d // (mf._BWD_THREADS // mf._BWD_LANES))
    assert chunk == l or (chunk % 8 == 0 and chunk < l
                          and chunk == mf._FWD_CUT)
    assert (chunk == l) == (blocks >= 132 or l <= 16)
    if (b, k, l, d) in VSSM_TINY_FWD or (b, k, l) in (
            (1, 4, 49), (2, 4, 197), (6, 4, 197), (4, 4, 197), (12, 4, 197)):
        assert chunk == l
    if (b, k, l) in ((1, 4, 197), (1, 2, 49)):
        assert chunk < l
    grid = mf.fwd_grid_blocks(b, k, l, d, 16, chunk)
    assert list(grid) == list(mf.FWD_KERNELS)
    assert grid["mamba_scan_kernel"] == -(-l // chunk) * blocks
    cut = chunk < l
    assert grid["mamba_scan_sums_kernel"] == (grid["mamba_scan_kernel"]
                                              if cut else 0)
    assert grid["mamba_scan_carry_kernel"] == (
        -(-b * k * 16 * d // mf._CARRY_THREADS) if cut else 0)


def test_mamba_fwd_sizes_match_the_kernel():
    """``_FWD_BLOCKS`` is the scan kernel's ``kFwdBlocks`` (its
    ``__launch_bounds__``), ``_FWD_CUT`` is ``kFwdCut``, the chunk length
    the summaries kernel is built for, and the workspace holds 1 + N
    floats a (b*k, chunk, channel), as ``csrc/mamba_fused.cu``'s layout
    comment gives it: about 16 MB at ARM-B, B=6, in chunks of 16; none for
    one chunk."""
    src = (CSRC / "mamba_fused.cu").read_text()
    assert re.findall(r"constexpr int kFwdBlocks = (\d+);", src) == [
        str(mf._FWD_BLOCKS)]
    assert re.findall(r"constexpr int kFwdCut = (\d+);", src) == [
        str(mf._FWD_CUT)]
    body = re.search(r"\bmamba_scan_sums_kernel\((.*?)\n}\n", src,
                     re.S).group(1)
    assert re.findall(r"chunk_sums<T, N, (\w+), false>", body) == ["kFwdCut"]
    meta = torch.device("meta")
    sums = mf._fwd_workspace(meta, 6 * 4, 197, 768, 16, 16)
    assert sums.shape == (24, 13, 17, 768)
    assert 16e6 < sums.numel() * 4 < 16.5e6
    assert mf._fwd_workspace(meta, 128 * 4, 3136, 192, 16, 3136) is None



# (B, K, L, C) of x_dbl: vssm_tiny's stages at B=128 and at validation's 64,
# ARM-B at serving, training and validation, and ragged ones (L short of a
# tile, C past a block's columns at 128 rows, one and two directions)
XDBL_VSSM = [(b, 4, l, c) for b in (128, 64) for l, c in
             ((3136, 38), (784, 44), (196, 56), (49, 80))]
XDBL_ARM = [(b, 4, 197, 80) for b in (1, 6, 12, 4)]
XDBL_OTHER = [(2, 4, 130, 11), (3, 2, 70, 44), (1, 1, 10, 12),
              (5, 4, 300, 38), (40, 4, 3136, 38), (1, 2, 65, 90)]


def _xdbl_cover(b, k, l, c, rows, dirs):
    """How often the kernel's grid writes each (image, direction, scan row,
    column), from its index arithmetic (``csrc/mamba_fused.cu``'s
    ``mamba_xdbl_kernel`` and its epilogue), for one range of D."""
    cols = mf.xdbl_block_cols(rows, dirs, c)
    groups = k // dirs
    hits = np.zeros((b, k, l, c), dtype=np.int32)
    for by in range(b * groups):
        img, k0 = by // groups, (by % groups) * dirs
        for bx in range(-(-l // rows)):
            s0 = bx * rows
            nrows = min(rows, l - s0)
            for bz in range(-(-c // cols)):
                c0 = bz * cols
                for kk in range(k0, k0 + dirs):
                    first = l - s0 - nrows if kk % 2 else s0
                    hits[img, kk, first:first + nrows,
                         c0:c0 + min(cols, c - c0)] += 1
    return hits


def _xdbl_slices(d, splits):
    """How often the kernel's ranges of D walk each 32-wide slice."""
    slices = -(-d // mf._XDBL_SLICE)
    per = -(-slices // splits)
    hits = np.zeros(slices, dtype=np.int32)
    for z in range(splits):
        hits[z * per:min(slices, (z + 1) * per)] += 1
    return hits


@pytest.mark.parametrize("b,k,l,c", XDBL_VSSM + XDBL_ARM + XDBL_OTHER)
def test_xdbl_tile_is_built_and_its_grid_covers_every_row(b, k, l, c):
    """``xdbl_tile`` picks rows and directions a block that the kernel is
    built for (64 or 128 rows, both directions of a source or one, one
    where K = 1): one direction a block where two would leave SMs idle
    (ARM-B, stage 3 at 64 images); ranges of D, doubled, only while the
    grid fills less than three quarters of two blocks an SM (ARM-B); 128
    rows only where a 128-row block holds all of C, takes fewer tiles of L
    than 64 rows and fills the card with its ranges (vssm_tiny stage 0,
    ARM-B from 4 images: the tiles an H100 ran fastest). Its grid, as
    ``xdbl_grid_blocks`` counts it, writes every (image, direction, scan
    row, column) of x_dbl once for each range, the reversed directions'
    rows included, and the ranges walk every slice of D once."""
    d = {3136: 192, 784: 384, 196: 768, 49: 1536, 197: 768}.get(l, 64)
    rows, dirs, splits = mf.xdbl_tile(b, k, l, d, c)
    assert rows in mf._XDBL_ROWS and dirs in (1, 2) and k % dirs == 0
    assert dirs == 1 or k > 1
    full = 3 * mf._XDBL_BLOCKS * 132
    if rows == 128:
        assert mf.xdbl_block_cols(128, dirs, c) >= c and l > 64
    if (b, k, l, c) in XDBL_VSSM:
        assert (rows, dirs, splits) == (
            (128, 2, 1) if l == 3136 else
            (64, 1, 1) if (b, l) == (64, 49) else (64, 2, 1))
    if (b, k, l, c) in XDBL_ARM:
        assert (rows, dirs, splits) == {1: (64, 1, 8), 4: (128, 1, 8),
                                        6: (128, 1, 8), 12: (128, 1, 4)}[b]
    cols = mf.xdbl_block_cols(rows, dirs, c)
    assert cols % 8 == 0 and (cols >= c or cols == 8 * 10 * (3 - dirs))
    grid = mf.xdbl_grid_blocks(b, k, l, c, rows, dirs, splits)
    assert grid == (-(-l // rows) * b * (k // dirs) * -(-c // cols)
                    * splits)
    slices = -(-d // mf._XDBL_SLICE)
    assert splits == 1 or 4 * (grid // 2) < full
    assert 4 * grid >= full or 2 * splits > slices // 3
    assert (_xdbl_slices(d, splits) == 1).all()
    if b * k * l * c <= 20_000_000:  # the coverage walk at a CPU's pace
        assert (_xdbl_cover(b, k, l, c, rows, dirs) == 1).all()


@pytest.mark.parametrize("rows,dirs", [(64, 2), (64, 1), (128, 2),
                                       (128, 1)])
def test_xdbl_forced_tiles_cover_every_row(rows, dirs):
    """Every tile the kernel takes covers x_dbl once at a ragged shape
    (what the card tests force at each of them), and any number of ranges
    walks each slice of D once (empty ranges past the last slice)."""
    assert (_xdbl_cover(3, 4, 130, 44, rows, dirs) == 1).all()
    for d, splits in ((8, 3), (70, 2), (768, 5), (1536, 8)):
        assert (_xdbl_slices(d, splits) == 1).all()


def test_xdbl_sizes_match_the_kernel():
    """``_XDBL_ROWS`` are the kernel's tile heights (``xdbl_rows`` of
    MW = 1, 2), ``_XDBL_SLICE`` its slice of D (``kXdblSlice``),
    ``_XDBL_TILES`` the n8 tiles a warp it is built for (``kXdblTiles``,
    and the instantiations ``MIA_XDBL_DISPATCH`` takes),
    ``_XDBL_BLOCKS`` the resident blocks its ``__launch_bounds__`` asks for
    (``kXdblBlocks``); the kernel takes its products from ``mma_tc.cuh``'s
    3xTF32 MMA, and the CUDA-core kernel's row cap is gone. The n8 tiles a
    warp are chosen in one place, ``xdbl_nt``: the library takes them as an
    argument, and its block's columns are ``xdbl_block_cols``' formula."""
    src = (CSRC / "mamba_fused.cu").read_text()
    rows = re.search(
        r"constexpr int xdbl_rows\(int mw\) \{ return (\d+) \* mw; \}",
        src).group(1)
    assert tuple(int(rows) * mw for mw in (1, 2)) == mf._XDBL_ROWS
    tiles = re.search(r"constexpr int kXdblTiles\[\] = \{([\d, ]+)\};",
                      src).group(1)
    assert tuple(int(t) for t in tiles.split(",")) == mf._XDBL_TILES
    dispatch = re.search(r"#define MIA_XDBL_DISPATCH(.*?)\n\n", src,
                         re.S).group(1)
    assert re.findall(r"fn<T, 1, (\d+)>", dispatch) == [
        str(t) for t in mf._XDBL_TILES]
    assert re.findall(r"fn<T, 2, (\d+)>", dispatch) == [
        str(mf._XDBL_TILES[0])]
    assert re.findall(r"constexpr int kXdblBlocks = (\d+);", src) == [
        str(mf._XDBL_BLOCKS)]
    assert re.findall(r"constexpr int kXdblSlice = (\d+);", src) == [
        str(mf._XDBL_SLICE)]
    body = re.search(r"__launch_bounds__\(kXdblThreads, kXdblBlocks\)\s+"
                     r"mamba_xdbl_kernel\((.*?)\n}\n", src, re.S).group(1)
    assert "tc::mma_3xtf32" in body and "kXdblMaxRows" not in src
    assert not hasattr(mf, "_XDBL_MAX_ROWS")
    assert not re.search(r"\bint xdbl_nt\(", src) and re.search(
        r"int mia_mamba_xdbl\(.*?int rows, int nt, int dirs,", src, re.S)
    assert re.search(r"int mia_mamba_xdbl_blocks_per_sm\(int rows, int nt, "
                     r"int dirs,", src)
    assert "return 8 * nt * (dirs == 1 ? 2 : 1);" in src


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("rows", [64, 128])
def test_xdbl_nt_is_a_built_instantiation(rows, dirs):
    """At every C from 1 to 200, ``xdbl_nt`` gives n8 tiles the kernel is
    built for at that height (``xdbl_built``: any of ``kXdblTiles`` at 64
    rows, the first at 128), the fewest that hold C where one does, and
    its block's columns are ``xdbl_block_cols``'."""
    for c in range(1, 201):
        nt = mf.xdbl_nt(rows, dirs, c)
        cols = 8 * nt * (3 - dirs)
        assert nt in (mf._XDBL_TILES[:1] if rows == 128 else mf._XDBL_TILES)
        assert mf.xdbl_block_cols(rows, dirs, c) == cols
        if rows == 64 and c <= 8 * mf._XDBL_TILES[-1] * (3 - dirs):
            assert cols >= c and all(
                8 * t * (3 - dirs) < c for t in mf._XDBL_TILES if t < nt)


@pytest.mark.parametrize("rows,dirs,c,cols", [
    (128, 2, 38, 40), (128, 1, 38, 80), (128, 2, 44, 40), (64, 2, 38, 40),
    (64, 2, 44, 48), (64, 2, 56, 56), (64, 2, 80, 80), (64, 1, 80, 80),
    (64, 1, 11, 80), (64, 2, 96, 80), (64, 1, 190, 160)])
def test_xdbl_block_cols_are_built_tiles(rows, dirs, c, cols):
    """A block's columns: the fewest n8 tiles a warp of those the kernel is
    built for that hold its share of C (5, 6, 7 or 10; 5 at 128 rows),
    twice with one direction a block; past that, more blocks along z."""
    assert mf.xdbl_block_cols(rows, dirs, c) == cols


def test_xdbl_timing_tool_names_the_kernel():
    """``tools/time_xdbl.py`` splits a tower's profile by name prefixes
    that cover the x_dbl kernel and the forward scan's kernels, and
    reckons launches for every main-path shape it times."""
    tool = _profile_tool("time_xdbl")
    kernels = {k for k in _kernels("mamba_fused.cu")
               if not k.startswith("mamba_scan_bwd")}
    assert "mamba_xdbl_kernel" in kernels
    for name in kernels:
        assert any(name.startswith(p) for p in tool.TOWER_KERNELS), name
    assert set(tool.LAUNCHES) == (
        {("arm-b", b) for b in (1, 6, 12, 4)}
        | {(f"vssm_tiny_s{s}", b) for s in range(4) for b in (128, 64)}
        | {("arm-l", b) for b in (12, 4)})
    # chip_smoke.py's launches of r2gengpt_mimic and vssm_classify (333)
    # and of am_mrg_mimic's ARM-L (288) (PERF.md 6)
    assert sum(tool.LAUNCHES.values()) == 333 + 288


def _profile_tool(name):
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(src: str) -> set:
    """The names of the ``__global__`` functions of a source in csrc/."""
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        (CSRC / src).read_text()))


# The csrc/vit_block.cu kernels that swin_attn_fwd launches.
SWIN_VIT_KERNELS = {"ln_stats_kernel", "ln_apply_kernel", "gemm_tc_kernel"}
# tool: (the kernels its profile must name, kernels that must be among
# them, a PyTorch kernel it must leave in "other"). The MAE step against
# every kernel of the ViT sub-layers' sources; the classification step
# against every kernel of the Swin sub-layer's source and the ViT block's
# that it launches.
PROFILE_TOOLS = {
    "profile_mae_step_torch": (
        lambda: _kernels("vit_block.cu") | _kernels("attn_tc.cuh"),
        {"gemm_tc_kernel", "attn_tc_fwd_kernel", "ln_apply_kernel"},
        "void at::native::vectorized_elementwise_kernel<4, float>"),
    "profile_cls_step_torch": (
        lambda: (_kernels("swin_block.cu")
                 | SWIN_VIT_KERNELS & _kernels("vit_block.cu")),
        {"swin_attn_core_kernel", *SWIN_VIT_KERNELS},
        "void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>>"),
}


@pytest.mark.parametrize("tool_name", sorted(PROFILE_TOOLS))
def test_profile_names_every_vit_kernel(tool_name):
    """Every kernel of the sub-layers a step profile reads falls into a
    named family of the tool, as the profiler prints it (namespaces,
    template arguments), so that its "other" bucket holds PyTorch's
    kernels only; the tensor-core GEMM is never counted as cuBLAS's."""
    tool = _profile_tool(tool_name)
    kernels, must, pytorch = PROFILE_TOOLS[tool_name]
    names = kernels()
    assert must <= names
    for name in sorted(names):
        key = f"void (anonymous namespace)::{name}<float, 32>(Args)"
        assert tool.family(key) != tool.OTHER, name
        assert "cuBLAS" not in tool.family(key), name
    assert tool.family(pytorch) == tool.OTHER


def test_scan_timing_tool_names_the_backward_kernel():
    """``tools/time_selective_scan_bwd.py`` reads the backward kernel's
    share of a step by a name that is a ``__global__`` function of
    ``csrc/selective_scan.cu``."""
    tool = _profile_tool("time_selective_scan_bwd")
    assert tool.KERNEL in _kernels("selective_scan.cu")


def test_scan_fwd_timing_tool_names_the_kernels():
    """``tools/time_selective_scan_fwd.py`` splits a call by a name prefix
    that covers the forward's ``__global__`` function of
    ``csrc/selective_scan.cu`` and not the backward's."""
    tool = _profile_tool("time_selective_scan_fwd")
    kernels = _kernels("selective_scan.cu")
    assert {k for k in kernels if k.startswith(tool.KERNELS)} == {
        "selective_scan_fwd_kernel"}
    assert "selective_scan_bwd_kernel" in kernels


def test_mamba_timing_tool_names_the_kernels():
    """``tools/time_mamba_scan_bwd.py`` splits a call by kernel name
    prefixes that cover every backward ``__global__`` function of
    ``csrc/mamba_fused.cu``, and the wrapper's ``BWD_KERNELS`` are those
    kernels."""
    tool = _profile_tool("time_mamba_scan_bwd")
    kernels = {k for k in _kernels("mamba_fused.cu")
               if k.startswith("mamba_scan_bwd")}
    assert set(mf.BWD_KERNELS) == kernels
    for name in kernels:
        assert any(name.startswith(p) for p in tool.KERNELS), name
    for prefix in tool.KERNELS:
        assert any(k.startswith(prefix) for k in kernels), prefix


def test_mamba_fwd_timing_tool_names_the_kernels():
    """``tools/time_mamba_scan_fwd.py`` splits a forward call by kernel
    name prefixes that cover every forward ``__global__`` function of
    ``csrc/mamba_fused.cu`` (those of the scan that are not the
    backward's or x_dbl's) and no backward one, and the wrapper's
    ``FWD_KERNELS`` are those kernels."""
    tool = _profile_tool("time_mamba_scan_fwd")
    kernels = {k for k in _kernels("mamba_fused.cu")
               if k.startswith("mamba_scan") and not k.startswith(
                   "mamba_scan_bwd")}
    assert set(mf.FWD_KERNELS) == kernels
    for name in kernels:
        assert any(name.startswith(p) for p in tool.KERNELS), name
    for prefix in tool.KERNELS:
        assert any(k.startswith(prefix) for k in kernels), prefix
        assert not prefix.startswith("mamba_scan_bwd"), prefix
    for name in kernels | set(mf.BWD_KERNELS):  # a tower's split
        assert any(name.startswith(p) for p in tool.TOWER_KERNELS), name


def test_scan_n1_timing_tool_names_the_kernels():
    """``tools/time_scan_n1_bwd.py`` splits a call by kernel name prefixes
    that cover every ``__global__`` function of ``csrc/scan_n1.cu``,
    ``tools/time_scan_n1_fwd.py`` by one that covers the forward's, and the
    wrapper's ``BWD_KERNELS`` and ``FWD_KERNELS`` are the backward's and
    the forward's kernels there."""
    tool = _profile_tool("time_scan_n1_bwd")
    kernels = _kernels("scan_n1.cu")
    assert set(sn.BWD_KERNELS) == {k for k in kernels
                                   if k.startswith("scan_n1_bwd")}
    assert set(sn.FWD_KERNELS) == {k for k in kernels
                                   if k.startswith("scan_n1_fwd")}
    fwd_tool = _profile_tool("time_scan_n1_fwd")
    assert {k for k in kernels if k.startswith(fwd_tool.KERNELS)} == set(
        sn.FWD_KERNELS)
    for name in kernels:
        assert any(name.startswith(p) for p in tool.KERNELS), name
    for prefix in tool.KERNELS:
        assert any(k.startswith(prefix) for k in kernels), prefix
