"""The port's op census (`halo2_plonky2_verifier_tpu_torch/utils/profiling.py`)
against the JAX package's, on the CPU.

The anchors (`tests/fixtures/census_anchors.json`) are the JAX census of one
proof of each configuration (`tools/gen_torch_census_anchors.py`).  The
port's census of the same proof equals them in every scope and metric, but
for the differences pinned here and listed in ROADMAP.md §3:

  bn254_mont_mul   the port counts 1,288 a BN254 permutation a lane (16
                   products a mix); the JAX census counts 520 a lane at
                   four lanes or more (its mix records max(_nelems) over a
                   broadcast).
  vanishing_poly_check, gl_mul and gl_add (JAX census, then the port's):
                   STARK: the JAX `CollectingConsumer.fold` is a lax.scan
                   with no multiplier, so it counts one entry of the alpha
                   fold; PLONK: the JAX `ExtOpsJax.mul_elems`/`mul_many`
                   count n^2 lanes for n products, lax.scan records a body
                   only at its first trace (PoseidonGate's second
                   full-round fold, CosetInterpolationGate's later chunks),
                   and the port folds the base-field alphas with
                   `scalar_mul` (2 products a term) where the JAX takes an
                   extension product (4).
"""

import json
import os

import pytest
import torch

import chip_smoke
from halo2_plonky2_verifier_tpu_torch import (build_verifier, load_proofs,
                                              plonk, proof_json, proof_shape,
                                              witness)
from halo2_plonky2_verifier_tpu_torch.circuit.common import load_circuit
from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark
from halo2_plonky2_verifier_tpu_torch.models.plonkish import PlonkishStark
from halo2_plonky2_verifier_tpu_torch.ops import bn254 as fr
from halo2_plonky2_verifier_tpu_torch.ops import poseidon as tpos
from halo2_plonky2_verifier_tpu_torch.ops import poseidon_bn254 as tpb
from halo2_plonky2_verifier_tpu_torch.utils import profiling
from halo2_plonky2_verifier_tpu_torch.utils.config import StarkConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
CONFIG = StarkConfig.standard_fast_config()
GLH, BN = "poseidon_goldilocks", "poseidon_bn254"
METRICS = ("gl_mul", "gl_add", "poseidon_permute", "bn254_mont_mul",
           "poseidon_bn254_permute")

with open(os.path.join(FIXTURES, "census_anchors.json")) as _f:
    ANCHORS = json.load(_f)

# config -> {scope path: {metric: (JAX census, the port's)}}
_STARK_FOLD = {"vanishing_poly_check": {"gl_mul": (252, 316),
                                        "gl_add": (84, 148)}}
DIVERGENCES = {
    "gl_n32": _STARK_FOLD,
    "gl_n2048": {"vanishing_poly_check": {"gl_mul": (270, 334),
                                          "gl_add": (96, 160)}},
    "bn254_caps_n32": _STARK_FOLD,
    "all_bn254_n32": _STARK_FOLD,
    "plonkish_n32": {"vanishing_poly_check": {"gl_mul": (248, 272),
                                              "gl_add": (92, 116)}},
    "plonk_fib_small": {"vanishing_poly_check": {"gl_mul": (1243, 1059),
                                                 "gl_add": (928, 816)}},
    "plonk_recmix_s60": {"vanishing_poly_check": {
        "gl_mul": (111553, 11197), "gl_add": (67142, 17986)}},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _read(name, count=1):
    return proof_json.read_jsonl(os.path.join(FIXTURES, name),
                                 proof_json.proof_from_json)[:count]


def stark_case(stark, name, hasher=GLH, transcript=GLH, count=1, npz=None):
    """(verify, CPU batch) of the first `count` proofs of a fixture; with
    `npz`, the proofs of that columnar fixture in the geometry of `name`'s
    first proof."""
    proofs = _read(name, count)
    db = proofs[0].proof.recover_degree_bits(CONFIG)
    shape = proof_shape(stark, CONFIG, db, hasher)
    if npz is None:
        batch = load_proofs(proofs, shape, "cpu")
    else:
        leaves = witness.npz_leaves(os.path.join(FIXTURES, npz))
        batch = witness.batch_from_numpy([x[:count] for x in leaves], shape,
                                         "cpu")
    return (build_verifier(stark, CONFIG, db, hasher=hasher,
                           transcript=transcript), batch)


def plonk_case(tag):
    common, vd, doc = load_circuit(
        os.path.join(FIXTURES, f"plonk_circuit_{tag}.json"))
    proofs = proof_json.read_jsonl(os.path.join(FIXTURES, doc["proofs"]),
                                   proof_json.plonk_proof_from_json)[:1]
    batch = plonk.load_plonk_proofs(proofs, plonk.plonk_proof_shape(common),
                                    vd, "cpu")
    return plonk.build_plonk_verifier(common, vd), batch


CASES = {
    "gl_n32": lambda: stark_case(FibonacciStark(32), "fib_stark_n32.json"),
    "gl_n2048": lambda: stark_case(FibonacciStark(2048),
                                   "fib_stark_n2048.json"),
    "bn254_caps_n32": lambda: stark_case(
        FibonacciStark(32), "fib_stark_n32_poseidon_bn254.json", BN),
    "all_bn254_n32": lambda: stark_case(
        FibonacciStark(32), "fib_stark_n32_poseidon_bn254.json", BN, BN,
        npz="fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz"),
    "plonkish_n32": lambda: stark_case(PlonkishStark(32),
                                       "plonkish_n32_x8.jsonl"),
    "plonk_fib_small": lambda: plonk_case("fib_small"),
}


def scopes(node, path=""):
    """{scope path: the node's own counts}, the root at ""."""
    counts = node["counts"] if isinstance(node, dict) else node.counts
    kids = (node["children"] if isinstance(node, dict)
            else node.children.values())
    out = {path: dict(counts)}
    for c in kids:
        name = c["name"] if isinstance(c, dict) else c.name
        out.update(scopes(c, f"{path}/{name}".lstrip("/")))
    return out


def census(name):
    """The census of one verify of case `name`, which must accept."""
    verify, batch = CASES[name]()
    with profiling.profile() as tree:
        ok = verify(batch)
    assert bool(ok.all())
    return tree


@pytest.mark.parametrize("name", list(CASES))
def test_census_equals_jax_anchor(name):
    """Scope by scope: the same scopes, and every count equal to the JAX
    census but the pinned divergences."""
    tree = census(name)
    got, want = scopes(tree.root), scopes(ANCHORS[name]["tree"])
    assert list(got) == list(want)
    pins = DIVERGENCES.get(name, {})
    for path in want:
        for m in METRICS:
            g, w = got[path].get(m, 0), want[path].get(m, 0)
            if m in pins.get(path, {}):
                assert (w, g) == pins[path][m], (path, m)
            elif m == "bn254_mont_mul":
                # 1,288 a BN254 permutation a lane, none outside one
                perms = got[path].get("poseidon_bn254_permute", 0)
                assert g == profiling.BN254_PERM_MONT_MUL * perms, path
            else:
                assert g == w, (path, m)
    if name == "gl_n32":
        assert tree.root.total("poseidon_permute") == 551
        assert got["get_stark_challenges"]["gl_mul"] == 22_184
        assert got["verify_fri/verify_merkle_proofs/two_to_one"][
            "gl_mul"] == 237_888
        assert tree.root.total("gl_mul") == 289_026 + 64
    if name == "bn254_caps_n32":
        assert tree.root.total("bn254_mont_mul") == 588 * 1288 == 757_344
    if name == "all_bn254_n32":
        assert tree.root.total("bn254_mont_mul") == 632 * 1288 == 814_016


def test_chip_smoke_anchors_are_the_pinned_census():
    """`chip_smoke.py` holds the card's census to the JAX anchor with the
    pinned divergences."""
    for name, want in chip_smoke.CENSUS_ANCHORS.items():
        totals = dict(ANCHORS[name]["totals"])
        for path, pins in DIVERGENCES[name].items():
            for m, (jax_n, port_n) in pins.items():
                totals[m] += port_n - jax_n
        assert want == {m: totals[m] for m in want}, name


def test_census_is_linear_in_lanes():
    """Two proofs count twice one, in every scope."""
    one = census("gl_n32")
    verify, batch = stark_case(FibonacciStark(32), "fib_stark_n32_x8.jsonl",
                               count=2)
    two = profiling.profile_verifier(verify, batch)
    s1, s2 = scopes(one.root), scopes(two.root)
    assert list(s1) == list(s2)
    for path in s1:
        assert s2[path] == {m: 2 * v for m, v in s1[path].items()}, path


def test_inactive_census_records_nothing():
    verify, batch = CASES["gl_n32"]()
    tree = profiling.ContextTree()
    assert not profiling.active()
    profiling.record("gl_mul", 123)
    verify(batch)
    assert tree.root.counts == {} and not tree.root.children
    with profiling.profile(tree):
        assert profiling.active()
    assert not profiling.active()


def test_permutation_constants_equal_a_live_jax_census():
    """472 gl_mul and 360 gl_add a Goldilocks permutation and 1,288
    bn254_mont_mul a BN254 permutation, at one lane: the JAX census of one
    permutation (a jax.eval_shape trace) and the port's, plain and through
    the permutation sites."""
    import jax
    import jax.numpy as jnp

    from halo2_plonky2_verifier_tpu.ops import poseidon as jpos
    from halo2_plonky2_verifier_tpu.ops import poseidon_bn254 as jpb
    from halo2_plonky2_verifier_tpu.utils import profiling as jprof

    with jprof.profile() as jt:
        jax.eval_shape(jpos.permute_planes,
                       (jnp.zeros((12, 1), jnp.uint32),
                        jnp.zeros((12, 1), jnp.uint32)))
    assert (jt.root.total("gl_mul"), jt.root.total("gl_add"),
            jt.root.total("poseidon_permute")) == (
        profiling.GL_PERM_MUL, profiling.GL_PERM_ADD, 1) == (472, 360, 1)
    with jprof.profile() as jt:
        jax.eval_shape(jpb.permute_mont, jnp.zeros((1, 4, 16), jnp.uint32))
    assert jt.root.total("bn254_mont_mul") == \
        profiling.BN254_PERM_MONT_MUL == 1288

    # the port's plain permutation, its field ops unsuspended, counts the
    # same products as its analytic record
    with profiling.profile() as t:
        with profiling.suspend():
            state = torch.zeros((12, 3), dtype=torch.int64)
        tpos.permute_planes_plain.__wrapped__(state)
    assert (t.root.total("gl_mul"), t.root.total("gl_add")) == (472 * 3,
                                                                360 * 3)
    # the BN254 body's S-boxes are mont_mul calls (3 each, 4 a full round
    # and one a partial one); its mix, 16 products a round, reduces a row at
    # once (`mont_matvec_limbs`) and is no mont_mul call
    with profiling.profile() as t:
        tpb.permute_mont_limbs.__wrapped__(
            fr.to_limbs(torch.zeros((2, 4, 4), dtype=torch.int64)))
    assert t.root.total("bn254_mont_mul") == 3 * (8 * 4 + 56) * 2
    assert 3 * (8 * 4 + 56) + 16 * 64 == 1288
    # and a site records once, suspended inside: 8 lanes count 8x
    with profiling.profile() as t:
        tpb.permute_mont(torch.zeros((8, 4, 4), dtype=torch.int64))
        tpos.permute(torch.zeros((5, 12), dtype=torch.int64))
    assert (t.root.total("poseidon_bn254_permute"),
            t.root.total("bn254_mont_mul"), t.root.total("poseidon_permute"),
            t.root.total("gl_mul")) == (8, 8 * 1288, 5, 5 * 472)


def test_report_collapsed_and_svg(tmp_path):
    tree = census("gl_n32")
    report = tree.report("gl_mul")
    assert "verify_merkle_proofs" in report and "two_to_one" in report
    assert "%" in report
    folded, svg = tmp_path / "c.folded", tmp_path / "c.svg"
    tree.write_collapsed(str(folded))
    tree.write_flamegraph_svg(str(svg), title="gl n=2^5")
    lines = folded.read_text().split("\n")
    assert "root;verify_fri;verify_merkle_proofs;two_to_one 237888" in lines
    text = svg.read_text()
    assert text.startswith("<svg") and "two_to_one" in text
    assert "verify_merkle_proofs" in text
    rev = tree.reversed_tree("gl_mul")
    assert rev.root.children["two_to_one"].total("gl_mul") == 237_888


def test_scope_enters_a_profiler_span():
    """A census scope is also a torch.profiler span of the same name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.scope("verify_fri"):
            torch.ones(3) + 1
    assert "verify_fri" in {e.key for e in prof.key_averages()}


def test_multiplier_scales_records():
    with profiling.profile() as t:
        with profiling.multiplier(3), profiling.scope("s"):
            profiling.record("gl_mul", 2)
    assert t.root.children["s"].counts == {"gl_mul": 6}
    assert profiling._MULTIPLIER == 1
