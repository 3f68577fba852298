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
timing tools their kernels.
"""

import importlib.util
import re
from pathlib import Path

import pytest

import torch

from medical_image_analysis_tpu_torch.ops import build
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
                                           ("kChunk", "_CHUNK")])
def test_selective_scan_sizes_match_the_kernel(constant, attr):
    """``_THREADS`` (channels a block: ``dB_part``'s and ``dC_part``'s
    leading extent) and ``_CHUNK`` (rows a carry: ``carries``' second
    extent) are the values of ``csrc/selective_scan.cu``'s constants."""
    src = (CSRC / "selective_scan.cu").read_text()
    want = re.findall(rf"constexpr int {constant} = (\d+);", src)
    assert len(want) == 1 and int(want[0]) == getattr(ssp, attr)


@pytest.mark.parametrize("constant,attr", [("kThreads", "_THREADS"),
                                           ("kChunk", "_CHUNK"),
                                           ("kSub", "_PIECE"),
                                           ("kCarryThreads", "_CARRY_THREADS")])
def test_scan_n1_sizes_match_the_kernel(constant, attr):
    """``_THREADS`` (channels a block: ``dxdbl_part``'s leading extent),
    ``_CHUNK`` (source rows a chunk of the backward: the weight-gradient
    partials' chunk extent), ``_PIECE`` (rows a slot of the workspaces) and
    ``_CARRY_THREADS`` (chains a block of the carry kernel, for
    ``bwd_grid_blocks``) are the values of ``csrc/scan_n1.cu``'s
    constants."""
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


def test_scan_n1_timing_tool_names_the_kernels():
    """``tools/time_scan_n1_bwd.py`` splits a call by kernel name prefixes
    that cover every ``__global__`` function of ``csrc/scan_n1.cu``, and
    the wrapper's ``BWD_KERNELS`` are the backward's kernels there."""
    tool = _profile_tool("time_scan_n1_bwd")
    kernels = _kernels("scan_n1.cu")
    assert set(sn.BWD_KERNELS) == {k for k in kernels
                                   if k.startswith("scan_n1_bwd")}
    for name in kernels:
        assert any(name.startswith(p) for p in tool.KERNELS), name
    for prefix in tool.KERNELS:
        assert any(k.startswith(prefix) for k in kernels), prefix
