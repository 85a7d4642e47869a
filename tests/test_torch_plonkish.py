"""The PyTorch port's PlonkishStark, on the CPU (the plain versions of every
kernel): the copied model against the JAX package's, the port's verdicts on
the plonkish fixtures (valid and tampered, in the repo's JSON and in
plonky2's serde JSON) against refimpl's, the challenges against refimpl's
`get_stark_challenges`, and the verifier's `check_vanishing` switch on a
proof whose quotient alone is wrong.

The fixtures and refimpl's verdicts come from
`tools/gen_torch_plonkish_fixtures.py`.  The JAX verifier is never
compiled here.  Integer results: the tolerance is 0.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu import proof_shape as jax_proof_shape
from halo2_plonky2_verifier_tpu import stark as jstark
from halo2_plonky2_verifier_tpu.interop import \
    stark_proof_from_plonky2_json as jax_from_plonky2
from halo2_plonky2_verifier_tpu.models import plonkish as jplonkish
from halo2_plonky2_verifier_tpu.ops import goldilocks as jgl
from halo2_plonky2_verifier_tpu.refimpl import verifier as ref_verifier
from halo2_plonky2_verifier_tpu.refimpl.proof import \
    proof_from_json as jax_proof_from_json
from halo2_plonky2_verifier_tpu.utils.config import \
    StarkConfig as JaxStarkConfig
from halo2_plonky2_verifier_tpu_torch import build_verifier, proof_shape
from halo2_plonky2_verifier_tpu_torch import stark as tstark
from halo2_plonky2_verifier_tpu_torch import transcript as ttr
from halo2_plonky2_verifier_tpu_torch.models import plonkish
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.parallel.dryrun import tiled_batch
from halo2_plonky2_verifier_tpu_torch.fixtures import read_docs
from halo2_plonky2_verifier_tpu_torch.interop import READERS
from halo2_plonky2_verifier_tpu_torch.utils.config import StarkConfig
from halo2_plonky2_verifier_tpu_torch.witness import load_proofs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
P = tgl.P
CONFIG = StarkConfig.standard_fast_config()

with open(os.path.join(FIXTURES, "plonkish_verdicts.json")) as _f:
    VERDICTS = json.load(_f)["files"]
PROOF_FILES = [name for name, v in VERDICTS.items() if "x0" in v
               and "break_gate_row" not in v]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain path's ops are small, so more threads only contend for
    the cores with the other test processes: one thread for this file,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Recorder:
    def __init__(self):
        self.out = []

    def constraint(self, c):
        self.out.append(("all", c))

    def constraint_last_row(self, c):
        self.out.append(("last", c))


def test_eval_matches_jax_model():
    """The copied PlonkishStark.eval emits the same constraints, in the
    same order, as the JAX class, each through its package's extension
    field ops (port ExtOps on int64 tensors, JAX ExtOpsJax on uint32
    pairs), on seeded values."""
    rng = np.random.default_rng(11)
    lanes = 16
    local, nxt = (rng.integers(0, P, size=(7, 2, lanes), dtype=np.uint64)
                  for _ in range(2))
    pis = rng.integers(0, P, size=(1, 2, lanes), dtype=np.uint64)

    def port(v):
        return [(tgl.from_u64(r[0], "cpu"), tgl.from_u64(r[1], "cpu"))
                for r in v]

    def jax_(v):
        return [(jgl.from_u64(r[0]), jgl.from_u64(r[1])) for r in v]

    got, want = _Recorder(), _Recorder()
    plonkish.PlonkishStark(32).eval(tstark.ExtOps((lanes,), "cpu"),
                                    port(local), port(nxt), port(pis), got)
    jplonkish.PlonkishStark(32).eval(jstark.ExtOpsJax((lanes,)),
                                     jax_(local), jax_(nxt), jax_(pis), want)
    assert [k for k, _ in got.out] == [k for k, _ in want.out] == \
        ["all", "last"]
    for (_, g), (_, w) in zip(got.out, want.out):
        for gc, wc in zip(g, w):
            assert np.array_equal(tgl.to_u64(gc),
                                  np.asarray(jgl.to_u64(tuple(
                                      jnp.asarray(x) for x in wc))))


@pytest.mark.parametrize("degree_bits", [5, 11])
def test_factors_and_shape_match_jax(degree_bits):
    """quotient_degree_factor 2, permutation_batch_size 2, one Z poly, and
    the whole proof shape equal the JAX package's."""
    mine, ref = plonkish.PlonkishStark(1 << degree_bits), \
        jplonkish.PlonkishStark(1 << degree_bits)
    jconfig = JaxStarkConfig.standard_fast_config()
    assert (mine.quotient_degree_factor(), mine.permutation_batch_size(),
            mine.num_permutation_batches(CONFIG), mine.constraint_degree()) \
        == (ref.quotient_degree_factor(), ref.permutation_batch_size(),
            ref.num_permutation_batches(jconfig), ref.constraint_degree()) \
        == (2, 2, 1, 3)
    assert [p.column_pairs for p in mine.permutation_pairs()] == \
        [p.column_pairs for p in ref.permutation_pairs()]
    assert dataclasses.asdict(proof_shape(mine, CONFIG, degree_bits)) == \
        dataclasses.asdict(jax_proof_shape(ref, jconfig, degree_bits))


def test_mul_add_chain_copy_matches_jax():
    for n, x0 in ((32, 3), (64, 12345)):
        _, trace, pis = plonkish.build_mul_add_chain(n, x0, x0, P)
        _, jtrace, jpis = jplonkish.build_mul_add_chain(n, x0, x0, P)
        assert (trace, pis) == (jtrace, jpis)


@pytest.mark.parametrize("name", PROOF_FILES)
def test_verdicts_equal_refimpl(name):
    """Every proof of a fixture file, untouched and under each tamper, in
    one CPU batch: the port's verdicts equal refimpl's, and the degree bits
    the port recovers from a proof equal refimpl's."""
    info = VERDICTS[name]
    entries = info["verdicts"]
    # one lane per entry: lanes of tampered entries take their tamper
    spec = {"fixture": name, "format": info["format"],
            "family": "plonkish", "num_rows": info["num_rows"],
            "size": len(entries), "device": "cpu",
            "tampers": {str(lane): e["tamper"]
                        for lane, e in enumerate(entries) if e["tamper"]}}
    for lane, e in enumerate(entries):
        assert lane % len(info["x0"]) == e["index"]
    stark, config, degree_bits, batch = tiled_batch(spec)
    got = build_verifier(stark, config, degree_bits)(batch)
    assert got.tolist() == [e["accepted"] for e in entries]
    doc = read_docs(name)[0]
    ref = (jax_from_plonky2 if info["format"] == "plonky2"
           else jax_proof_from_json)(json.dumps(doc))
    assert degree_bits == ref.proof.recover_degree_bits(
        JaxStarkConfig.standard_fast_config())
    assert 1 << degree_bits == info["num_rows"]


def test_challenges_equal_refimpl():
    """The port's transcript on one plonkish proof gives refimpl's
    `get_stark_challenges`, permutation challenges and all 84 query
    indices included."""
    name = "plonkish_n32_x8.jsonl"
    doc = read_docs(name)[1]
    ref_pwp = jax_proof_from_json(json.dumps(doc))
    want = ref_verifier.get_stark_challenges(
        ref_pwp.proof, jplonkish.PlonkishStark(32),
        JaxStarkConfig.standard_fast_config())
    _, _, _, batch = tiled_batch({"fixture": name, "family": "plonkish",
                                  "num_rows": 32, "size": 1,
                                  "device": "cpu"}, range(1, 2))
    sched, elements, refs = tstark.challenge_stream(batch)
    ys = ttr.run_schedule(sched, elements)

    def val(ref):
        return int(tgl.to_u64(ttr.extract(ys, ref))[0])

    def ext(pair):
        return (val(pair[0]), val(pair[1]))

    assert [val(r) for r in refs["alphas"]] == want["stark_alphas"]
    assert ext(refs["zeta"]) == tuple(want["stark_zeta"])
    assert ext(refs["fri_alpha"]) == tuple(want["fri_alpha"])
    assert [ext(r) for r in refs["betas"]] == \
        [tuple(b) for b in want["fri_betas"]]
    assert val(refs["pow"]) == want["fri_pow_response"]
    assert [val(r) for r in refs["queries"]] == want["fri_query_indices"]
    assert [[(val(b), val(g)) for (b, g) in cset] for cset in refs["perm"]] \
        == [[tuple(c) for c in cset]
            for cset in want["permutation_challenge_sets"]]


def test_check_vanishing_switch():
    """A proof of a trace with one broken gate: its FRI holds and its
    quotient does not meet the constraint.  The default verifier rejects
    it, `check_vanishing=False` accepts it, as refimpl does; a valid proof
    in the same batch passes both."""
    name = "plonkish_n32_bad_gate.jsonl"
    want = {e["check_vanishing"]: e["accepted"]
            for e in VERDICTS[name]["verdicts"]}
    assert want == {True: False, False: True}
    proofs = [READERS["native"](d) for d in
              read_docs(name) + read_docs("plonkish_n32_x8.jsonl")[:1]]
    stark = plonkish.PlonkishStark(32)
    shape = proof_shape(stark, CONFIG, 5)
    batch = load_proofs(proofs, shape, "cpu")
    for check in (True, False):
        got = build_verifier(stark, CONFIG, 5, check_vanishing=check)(batch)
        assert got.dtype == torch.bool
        assert got.tolist() == [want[check], True]
