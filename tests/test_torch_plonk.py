"""The PyTorch port's plonky2 PLONK verifier, on the CPU (the plain versions
of every kernel): the circuit data rebuilt from the fixtures against the
JAX package's circuit builder and the frozen anchors, the gate and
vanishing terms against refimpl's term by term, and whole verifications
against refimpl's verdicts and the frozen challenges.

The JAX PLONK verifier is never compiled here (minutes even for the small
circuits); `tests/test_plonk_jax.py` holds it against the same refimpl
reference.  refimpl's verdicts on the recmix and recursive-fib proofs are
the ones `tools/gen_torch_plonk_fixtures.py` recorded in the circuit
fixtures; on the two small circuits the test also runs refimpl live.
Integer results: the tolerance is 0.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu.refimpl.field_ops import ExtOps as RefExtOps
from halo2_plonky2_verifier_tpu.refimpl.plonk import (
    plonk_proof_from_json as ref_plonk_from_json)
from halo2_plonky2_verifier_tpu.refimpl.plonk import verify as ref_verify
from halo2_plonky2_verifier_tpu.refimpl.plonk.circuit import \
    compute_circuit_digest as ref_digest
from halo2_plonky2_verifier_tpu.refimpl.plonk.vanishing import \
    eval_vanishing_terms as ref_vanishing
from halo2_plonky2_verifier_tpu.refimpl.verifier import VerificationError
from halo2_plonky2_verifier_tpu_torch import plonk, proof_json
from halo2_plonky2_verifier_tpu_torch.circuit import (circuit_from_json,
                                                      compute_circuit_digest,
                                                      load_circuit)
from halo2_plonky2_verifier_tpu_torch.circuit.vanishing import \
    eval_vanishing_terms
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as gl
from halo2_plonky2_verifier_tpu_torch.stark import ExtOps, _ext_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
sys.path.insert(0, os.path.join(REPO, "tools"))
import gen_torch_plonk_fixtures as gen  # noqa: E402

TAGS = list(gen.CIRCUITS)
SMALL = ["fib_small", "logup"]
P = gl.P
_REF = {}


def _circuit(tag):
    return load_circuit(os.path.join(FIXTURES, f"plonk_circuit_{tag}.json"))


def _ref_circuit(tag):
    """refimpl's (common, verifier_data) from the JAX package's circuit
    builder (a fraction of a second each)."""
    if tag not in _REF:
        _REF[tag] = gen.CIRCUITS[tag][1]()[:2]
    return _REF[tag]


def _docs(doc):
    with open(os.path.join(FIXTURES, doc["proofs"])) as f:
        return [json.loads(line) for line in f if line.strip()]


def _anchor(name):
    with open(os.path.join(FIXTURES, "golden_anchors.json")) as f:
        return next(a for a in json.load(f)["plonk_anchors"]
                    if a["circuit"] == name)


def _u(t):
    return [int(x) for x in gl.to_u64(t)]


# ----------------------------------------------------------------------------
# circuit data
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("tag", SMALL)
def test_rebuilt_common_matches_the_circuit_builder(tag):
    """For the small circuits, the common data rebuilt from the fixture is
    the JAX package's `b.build()`'s."""
    common, vd, doc = _circuit(tag)
    ref, ref_vd = _ref_circuit(tag)
    assert [g.id() for g in common.gates] == [g.id() for g in ref.gates]
    assert common.selector_groups == [tuple(g) for g in ref.selector_groups]
    assert common.k_is == ref.k_is
    assert common.num_gate_constraints == ref.num_gate_constraints
    assert common.num_constants == ref.num_constants
    assert common.num_partial_products == ref.num_partial_products
    assert common.num_lookup_polys == ref.num_lookup_polys
    assert [(lut.table, lut.num_slots, lut.sel_lk, lut.sel_tbl)
            for lut in common.luts] == [
        (lut.table, lut.num_slots, lut.sel_lk, lut.sel_tbl)
        for lut in ref.luts]
    assert vd.constants_sigmas_cap == ref_vd.constants_sigmas_cap
    shape = plonk.plonk_proof_shape(common)
    zeta = (12345, 678)
    want = ref.fri_instance_batches(zeta)
    assert plonk.fri_instance_polys(shape) == (want[0][1], want[1][1])


@pytest.mark.parametrize("tag,name", [("recmix_s60", "plonk_recmix_s60"),
                                      ("recursive_fib_n8", "recursive_fib_n8")])
def test_fixture_matches_the_frozen_anchors(tag, name):
    common, vd, doc = _circuit(tag)
    a = _anchor(name)
    assert doc["name"] == name
    assert common.degree_bits == a["degree_bits"]
    assert [str(x) for x in vd.circuit_digest] == a["circuit_digest"]
    if "constants_sigmas_cap_first4" in a:
        assert [[str(x) for x in h] for h in vd.constants_sigmas_cap[:4]] \
            == a["constants_sigmas_cap_first4"]


@pytest.mark.parametrize("tag", TAGS)
def test_digest_recomputes_from_the_cap(tag):
    common, vd, _ = _circuit(tag)
    got = compute_circuit_digest(vd.constants_sigmas_cap, common.degree_bits)
    assert got == vd.circuit_digest
    assert got == list(ref_digest(vd.constants_sigmas_cap,
                                  common.degree_bits))


def _drop_gate(d):
    d["gates"].pop(3)


def _rename_gate(d):
    d["gates"][1]["params"]["max_degree"] += 1


def _bad_digest(d):
    d["circuit_digest"][0] = str(int(d["circuit_digest"][0]) ^ 1)


def _bad_cap(d):
    d["constants_sigmas_cap"][2][1] = "7"


@pytest.mark.parametrize("spoil", [_drop_gate, _rename_gate, _bad_digest,
                                   _bad_cap])
def test_loader_refuses_a_fixture_that_does_not_hold_together(spoil):
    with open(os.path.join(FIXTURES, "plonk_circuit_recmix_s60.json")) as f:
        doc = json.load(f)
    circuit_from_json(doc)
    spoil(doc)
    with pytest.raises(ValueError):
        circuit_from_json(doc)


# ----------------------------------------------------------------------------
# gates and vanishing terms
# ----------------------------------------------------------------------------

def _seeded_inputs(common, seed, b=4):
    """Seeded extension values at a batch of b: the port's tensors and, per
    lane, refimpl's ints."""
    rng = np.random.default_rng(seed)
    cfg = common.config
    counts = {"constants": common.num_constants,
              "sigmas": cfg.num_routed_wires, "wires": cfg.num_wires,
              "zs": cfg.num_challenges, "zs_next": cfg.num_challenges,
              "pps": cfg.num_challenges * common.num_partial_products,
              "lzs": common.num_lookup_polys,
              "lzs_next": common.num_lookup_polys,
              "pi_hash": 4, "x": 1, "l0": 1}
    ext = {k: rng.integers(0, P, size=(b, n, 2), dtype=np.uint64)
           for k, n in counts.items()}
    base = {k: rng.integers(0, P, size=(b, n), dtype=np.uint64)
            for k, n in (("betas", cfg.num_challenges),
                         ("gammas", cfg.num_challenges),
                         ("deltas", 2 * cfg.num_challenges
                          if common.luts else 0))}
    port = {k: _ext_rows(gl.from_u64(v)) for k, v in ext.items()}
    port.update({k: [gl.from_u64(v[:, i]) for i in range(v.shape[1])]
                 for k, v in base.items()})

    def lane(i):
        d = {k: [(int(e[0]), int(e[1])) for e in v[i]]
             for k, v in ext.items()}
        d.update({k: [int(x) for x in v[i]] for k, v in base.items()})
        return d
    return port, [lane(i) for i in range(b)]


def _terms(fn, F, common, v, x, l0):
    return fn(F, common, x, v["constants"], v["sigmas"], v["wires"], v["zs"],
              v["zs_next"], v["pps"], v["pi_hash"], v["betas"], v["gammas"],
              l0, lookup_zs=v["lzs"], lookup_zs_next=v["lzs_next"],
              deltas=v["deltas"])


@pytest.mark.parametrize("tag", TAGS)
def test_vanishing_terms_equal_refimpl(tag):
    """The port's `eval_vanishing_terms` over its CPU ExtOps equals
    refimpl's over `refimpl/field_ops.ExtOps`, term by term and lane by
    lane, on seeded values (the logUp circuit covers `lookup_terms`)."""
    common, _, _ = _circuit(tag)
    ref, _ = _ref_circuit(tag)
    port, lanes = _seeded_inputs(common, sum(map(ord, tag)))
    got = _terms(eval_vanishing_terms, ExtOps((4,), "cpu"), common, port,
                 port["x"][0], port["l0"][0])
    for i, v in enumerate(lanes):
        want = _terms(ref_vanishing, RefExtOps, ref, v, v["x"][0], v["l0"][0])
        assert len(got) == len(want)
        for j, (t, w) in enumerate(zip(got, want)):
            assert (int(gl.to_u64(t[0])[i]), int(gl.to_u64(t[1])[i])) == w, \
                (tag, i, j)


def _verdict_batch(tag):
    """Every proof of the circuit's file, untouched and tampered, as one
    CPU batch, with the verdicts the fixture records for refimpl."""
    common, vd, doc = _circuit(tag)
    docs = _docs(doc)
    proofs, want = [], []
    for v in doc["refimpl_verdicts"]:
        d = docs[v["index"]]
        if v["tamper"] is not None:
            d = gen.tampered(d, v["tamper"])
        proofs.append(proof_json.plonk_proof_from_json(d))
        want.append(v["accepted"])
    shape = plonk.plonk_proof_shape(common)
    return common, vd, plonk.load_plonk_proofs(proofs, shape, vd, "cpu"), want


@pytest.mark.parametrize("tag", TAGS)
def test_verdicts_equal_refimpl(tag):
    """Every valid proof accepted, exactly the tampered lanes (public input,
    wire opening, Merkle sibling, quotient opening; logUp: a lookup Z)
    rejected: refimpl's verdicts lane by lane."""
    common, vd, batch, want = _verdict_batch(tag)
    got = plonk.build_plonk_verifier(common, vd)(batch)
    assert got.dtype == torch.bool
    assert got.tolist() == want
    assert any(want) and not all(want)


@pytest.mark.parametrize("tag", SMALL)
def test_recorded_verdicts_are_refimpls(tag):
    """The recorded verdicts are what refimpl.plonk.verify says now."""
    ref, ref_vd = _ref_circuit(tag)
    _, _, doc = _circuit(tag)
    docs = _docs(doc)
    for v in doc["refimpl_verdicts"]:
        d = docs[v["index"]]
        if v["tamper"] is not None:
            d = gen.tampered(d, v["tamper"])
        try:
            ref_verify(ref, ref_vd, ref_plonk_from_json(json.dumps(d)))
            accepted = True
        except VerificationError:
            accepted = False
        assert accepted == v["accepted"], v


@pytest.mark.parametrize("tag,name", [("recmix_s60", "plonk_recmix_s60"),
                                      ("recursive_fib_n8", "recursive_fib_n8")])
def test_challenges_equal_the_frozen_anchors(tag, name):
    """Proof 0's public inputs and Fiat-Shamir challenges through the
    port's transcript (the plain K2 and K7) equal the frozen anchors."""
    common, vd, doc = _circuit(tag)
    a = _anchor(name)
    proof = proof_json.plonk_proof_from_json(_docs(doc)[0])
    shape = plonk.plonk_proof_shape(common)
    batch = plonk.load_plonk_proofs([proof], shape, vd, "cpu")
    ch = plonk.plonk_challenges(batch, vd)
    assert [str(x) for x in _u(batch.public_inputs[0])] == a["public_inputs"]
    assert [str(x) for x in _u(torch.stack(ch["zeta"])[:, 0])] \
        == a["plonk_zeta"]
    assert str(_u(ch["fri_pow_response"])[0]) == a["fri_pow_response"]
    for key in ("betas", "gammas", "alphas"):
        if f"plonk_{key}" in a:
            assert [str(_u(x)[0]) for x in ch[key]] == a[f"plonk_{key}"]
    if "fri_alpha" in a:
        assert [str(x) for x in _u(torch.stack(ch["fri_alpha"])[:, 0])] \
            == a["fri_alpha"]
    if "fri_betas" in a:
        assert [[str(x) for x in _u(torch.stack(b)[:, 0])]
                for b in ch["fri_betas"]] == a["fri_betas"]
    if "fri_query_indices_first8" in a:
        assert [str(x) for x in _u(ch["queries"][0, :8])] \
            == a["fri_query_indices_first8"]


def _drop_wire(d):
    d["openings"]["wires"].pop()


def _drop_sibling(d):
    d["opening_proof"]["query_round_proofs"][0]["initial_trees_proof"][1][
        "siblings"].pop()


def _drop_query(d):
    d["opening_proof"]["query_round_proofs"].pop()


@pytest.mark.parametrize("spoil", [_drop_wire, _drop_sibling, _drop_query])
def test_loader_refuses_a_proof_of_another_geometry(spoil):
    """A proof whose counts are not the circuit's is refused at load, with
    ValueError, not read past or verified at the wrong shape."""
    common, vd, doc = _circuit("fib_small")
    bad = _docs(doc)[0]
    spoil(bad)
    shape = plonk.plonk_proof_shape(common)
    with pytest.raises(ValueError):
        plonk.load_plonk_proofs([proof_json.plonk_proof_from_json(bad)],
                                shape, vd, "cpu")


def test_verifier_refuses_a_batch_of_another_shape():
    common, vd, batch, _ = _verdict_batch("fib_small")
    other, _, _ = _circuit("logup")
    with pytest.raises(ValueError):
        plonk.build_plonk_verifier(other, vd)(batch)
    more_inputs = dataclasses.replace(
        common, num_public_inputs=common.num_public_inputs + 1)
    with pytest.raises(ValueError):
        plonk.build_plonk_verifier(more_inputs, vd)(batch)
