"""The tune tools' variant builds, without a card: every variant of
`tools/torch_gl_tune.py` (K1, K2, K3, K7, K8) and
`tools/torch_bn254_tune.py` (K4, K5, K6) is a copy of the port's CUDA
sources with text substitutions, so each substitution must still find its
text in the sources (a kernel edited without its tuner would otherwise fail
only on the card), each variant must carry its parameters into the copy, and
a variant built from another commit's sources (--parent) must include that
commit's headers, not this one's.  The launch paths the tuners substitute
(K5's choice by w, K7's launch, K3's and K8's sized launch) are pinned here
by the same texts.  No nvcc runs: only the copied sources are read.
"""

import os
import sys

import pytest

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.append(TOOLS)

import torch_bn254_tune as bt  # noqa: E402
import torch_gl_tune as gt  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.ops import _build  # noqa: E402

VARIANTS = (gt.K1_VARIANTS + gt.K2_VARIANTS + gt.K3_VARIANTS
            + gt.K7_VARIANTS + gt.K8_VARIANTS + bt.K4_VARIANTS
            + bt.K5_VARIANTS + bt.K6_VARIANTS + bt.BODY_VARIANTS)


def test_variant_tags_are_unique():
    tags = [v[0] for v in VARIANTS]
    assert len(tags) == len(set(tags))


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_variant_substitutes_into_the_sources(tmp_path, variant):
    """The copy holds every substitution's new text, and every header of
    csrc/ sits beside it (the copies the source's #include finds)."""
    tag, params, source, subs = variant
    path = gt.variant_source(tag, source, subs, out=tmp_path)
    d = os.path.dirname(path)
    assert os.path.basename(path) == source
    for name, pairs in subs.items():
        text = open(os.path.join(d, name)).read()
        for old, new in pairs:
            assert new in text
            if old not in new:
                assert old not in text
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert headers <= set(os.listdir(d))
    for value in params.values():
        if isinstance(value, int) and value > 1:
            assert str(value) in open(path).read() + "".join(
                open(os.path.join(d, n)).read() for n in subs)


def test_missing_text_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not found"):
        gt.variant_source("bad", "permute.cu",
                          {"permute.cu": [("no such text", "x")]},
                          out=tmp_path)


def test_parent_variant_takes_the_parent_headers(tmp_path):
    """A --parent variant copies the source and the headers from the
    parent's directory (a checkout's csrc/ under it, or the directory)."""
    parent = tmp_path / "parent" / "halo2_plonky2_verifier_tpu_torch" / \
        "ops" / "csrc"
    parent.mkdir(parents=True)
    (parent / "permute.cu").write_text("// the parent's K7\n")
    (parent / "poseidon_gl.cuh").write_text("// the parent's body\n")
    base = gt.parent_csrc(tmp_path / "parent")
    assert base == parent and gt.parent_csrc(parent) == parent
    path = gt.variant_source("p", "permute.cu", {}, base, out=tmp_path / "v")
    d = os.path.dirname(path)
    assert open(path).read() == "// the parent's K7\n"
    assert sorted(os.listdir(d)) == ["permute.cu", "poseidon_gl.cuh"]


def test_launch_paths_the_tuners_substitute():
    """K5 chooses its launch shape by w alone: the sponge (w > 3) at 256 x
    1, the packing (w <= 3) at 128 x 4, the two paths the sweep
    measured; K7 has one launch for every N.  The launch each variant
    replaces occurs once in its source, beside the one entry point."""
    leaf = (_build.CSRC / "bn254_leaf.cu").read_text()
    assert leaf.count(bt.K5_LAUNCH) == 1 and leaf.count(bt.K5_ENTRY) == 1
    assert leaf.count("launch<") == 2
    assert bt.K5_LAUNCH.split("\n")[0].strip() == "if (w > 3)"
    assert "launch<256, 1>" in bt.K5_LAUNCH.split("\n")[1]
    assert "launch<128, 4>" in bt.K5_LAUNCH.split("\n")[3]
    permute = (_build.CSRC / "permute.cu").read_text()
    assert permute.count(gt.K7_LAUNCH) == 1
    assert permute.count(gt.K7_ENTRY) == 1
    assert gt.K7_PARTIAL in permute and all(s in permute for s in gt.K7_SHAPE)


def test_sized_launch_texts_the_tuner_substitutes():
    """K3 and K8 launch through sized_launch.cuh, once each, at the shapes
    and unrolling the sweeps replace, K3 with a lane loop and K8 one lane a
    thread (the lane and the kernel's last store, which the variants of the
    other form swap, once each); the
    sizing computes its threads and
    blocks once; K3's sponge makes its permutations at one call, the one
    the short-last-permutation variant splits."""
    for source, sized, shape, partial, lane, tail in (
            ("leaf_sponge.cu", gt.K3_SIZED, gt.K3_SHAPE, gt.K3_PARTIAL,
             gt.LANE_LOOP, gt.K3_TAIL),
            ("permute_chained.cu", gt.K8_SIZED, gt.K8_SHAPE, gt.K8_PARTIAL,
             gt.LANE, gt.K8_TAIL)):
        text = (_build.CSRC / source).read_text()
        assert text.count(sized) == 1 and text.count("sized_launch<") == 1
        assert all(text.count(s) == 1
                   for s in (*shape, partial, lane, tail))
    sizing = (_build.CSRC / "sized_launch.cuh").read_text()
    assert sizing.count(gt.SIZED_THREADS) == 1
    assert sizing.count(gt.SIZED_BLOCKS) == 1
    body = (_build.CSRC / "poseidon_gl.cuh").read_text()
    assert body.count(gt.K3_LAST_PERMUTE) == 1
    assert body.count(gt.K3_SPONGE) == 1


SASS = """
	code for sm_90a
		Function : _Z18bn254_micro_kernelILi7ELi512EEvPKmPmli
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                                /* 0x000fe40000000800 */
        /*0010*/                   IMAD.WIDE.U32 R4, R2, R3, R4 ;               /* 0x0000000302047225 */
        /*0020*/                   IMAD.WIDE.U32 R6, R2, R8, R6 ;               /* 0x0000000802067225 */
        /*0030*/                   IADD3 R5, P0, R5, R6, RZ ;                   /* 0x0000000605057210 */
        /*0040*/              @!P1 IADD3.X R7, R7, RZ, RZ, P0, !PT ;            /* 0x000000ff07079210 */
        /*0050*/                   HFMA2.MMA R9, -RZ, RZ, 0, 0 ;                /* 0x00000000ff097435 */
        /*0060*/                   BRA 0x60;                                    /* 0xfffffffc00fc7947 */
		..........

		Function : _Z22bn254_micro_mul_kernelILi11ELi8EEvPKmPmlli
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;      /* 0x00000a00ff017624 */
        /*0010*/                   SEL R2, R3, R4, P0 ;                         /* 0x0000000403027207 */
        /*0020*/                   MOV R5, R6 ;                                 /* 0x0000000600057202 */
        /*0030*/                   IMAD.WIDE.U32 R8, R8, -0x61c88648, R8 ;      /* 0x9e3779b808087825 */
        /*0040*/                   EXIT ;                                       /* 0x000000000000794d */
		..........
"""


def test_bn254_function_census_splits_by_kernel_instance():
    """The k9 census counts each function's SASS opcodes under the name
    `torch_bn254_micro.kernel_instance` gives its probe run, so each probe
    reads its own template instance's instructions."""
    import torch_bn254_micro as tm
    out = bt.function_census(SASS)
    permute = out[tm.kernel_instance("permute", 0, 1)]
    assert permute == {"LDC": 1, "IMAD.WIDE.U32": 2, "IADD3": 1,
                       "IADD3.X": 1, "HFMA2.MMA": 1, "BRA": 1}
    wide = out[tm.kernel_instance("wide_mul16", 0, 8)]
    assert {op: wide[op] for op in bt.K9_OPCODES} == {
        "IMAD.WIDE.U32": 1, "IADD3": 0, "IADD3.X": 0, "MOV": 1,
        "IMAD.MOV.U32": 1, "HFMA2.MMA": 0, "SEL": 1}
    assert sum(out.values(), type(wide)())["IMAD.WIDE.U32"] == 3
