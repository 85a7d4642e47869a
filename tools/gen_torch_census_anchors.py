"""Write the op-census anchors that the PyTorch port's census is held to:
`tests/fixtures/census_anchors.json`, the JAX package's census
(`utils/profiling.py:profile_verifier`, a `jax.eval_shape` trace: nothing is
compiled or run) of one proof of each configuration below.

For each configuration the file holds the source proof, the totals of every
metric (gl_mul, gl_add, poseidon_permute, bn254_mont_mul,
poseidon_bn254_permute) and the scope tree, each node with its own counts
and its children in the order the verifier enters them:

  gl_n32           fib_stark_n32.json, Poseidon-Goldilocks caps and
                   transcript (the flagship geometry);
  gl_n2048         fib_stark_n2048.json (the fold shape);
  bn254_caps_n32   fib_stark_n32_poseidon_bn254.json, BN254 caps with the
                   Goldilocks transcript;
  all_bn254_n32    the first proof of
                   fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz, BN254
                   caps and transcript (the repo has no JSON proof of it;
                   the census depends on the geometry only);
  plonkish_n32     the first proof of plonkish_n32_x8.jsonl;
  plonk_fib_small  the first proof of plonk_fib_small_x3.jsonl, with the
                   circuit of `tools/gen_torch_plonk_fixtures.py`;
  plonk_recmix_s60 the first proof of plonk_recmix_s60_x4.jsonl (the bench
                   circuit).

The tool reads fixtures and writes no proof.  Nothing in the port imports
it; the counterpart of `tools/gen_torch_plonk_fixtures.py`.

Usage: JAX_PLATFORMS=cpu python tools/gen_torch_census_anchors.py
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.join(REPO, "tools"))

FIXTURES = os.path.join(REPO, "tests", "fixtures")
OUT = os.path.join(FIXTURES, "census_anchors.json")
METRICS = ("gl_mul", "gl_add", "poseidon_permute", "bn254_mont_mul",
           "poseidon_bn254_permute")


def tree_json(node):
    """A census node as {"name", "counts", "children"}."""
    return {"name": node.name, "counts": dict(node.counts),
            "children": [tree_json(c) for c in node.children.values()]}


def _stark_census(stark, pwp, hasher, transcript, batch=None):
    from halo2_plonky2_verifier_tpu import (build_verifier, load_proofs,
                                            proof_shape)
    from halo2_plonky2_verifier_tpu.utils import profiling
    from halo2_plonky2_verifier_tpu.utils.config import StarkConfig

    config = StarkConfig.standard_fast_config()
    degree_bits = pwp.proof.recover_degree_bits(config)
    shape = proof_shape(stark, config, degree_bits, hasher)
    if batch is None:
        batch = load_proofs([pwp], shape)
    verify = build_verifier(stark, config, degree_bits, hasher=hasher,
                            transcript=transcript)
    return profiling.profile_verifier(verify, batch)


def _read(name):
    from halo2_plonky2_verifier_tpu.refimpl.proof import proof_from_json

    with open(os.path.join(FIXTURES, name)) as f:
        return proof_from_json(f.readline())


def _fib(name, hasher="poseidon_goldilocks"):
    from halo2_plonky2_verifier_tpu.models.fibonacci import FibonacciStark

    pwp = _read(name)
    n = int(name.split("_n")[1].split("_")[0].split(".")[0])
    return _stark_census(FibonacciStark(n), pwp, hasher,
                         "poseidon_goldilocks")


def _all_bn254():
    """The npz's leaves, cut to the first proof, in the pytree of a BN254
    batch of the same geometry (the BN254-caps JSON proof's)."""
    import jax
    import numpy as np

    from halo2_plonky2_verifier_tpu import load_proofs, proof_shape
    from halo2_plonky2_verifier_tpu.models.fibonacci import FibonacciStark
    from halo2_plonky2_verifier_tpu.utils.config import StarkConfig

    stark = FibonacciStark(32)
    pwp = _read("fib_stark_n32_poseidon_bn254.json")
    config = StarkConfig.standard_fast_config()
    shape = proof_shape(stark, config, pwp.proof.recover_degree_bits(config),
                        "poseidon_bn254")
    _, treedef = jax.tree_util.tree_flatten(load_proofs([pwp], shape))
    data = np.load(os.path.join(
        FIXTURES, "fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz"))
    leaves = [data[f"a{i}"][:1] for i in range(treedef.num_leaves)]
    batch = jax.tree_util.tree_unflatten(treedef, leaves)
    return _stark_census(stark, pwp, "poseidon_bn254", "poseidon_bn254",
                         batch)


def _plonkish():
    from halo2_plonky2_verifier_tpu.models.plonkish import PlonkishStark

    return _stark_census(PlonkishStark(32), _read("plonkish_n32_x8.jsonl"),
                         "poseidon_goldilocks", "poseidon_goldilocks")


def _plonk(tag):
    from gen_torch_plonk_fixtures import CIRCUITS

    from halo2_plonky2_verifier_tpu.plonk import (build_plonk_verifier,
                                                  load_plonk_proofs,
                                                  plonk_proof_shape)
    from halo2_plonky2_verifier_tpu.refimpl.plonk import plonk_proof_from_json
    from halo2_plonky2_verifier_tpu.utils import profiling

    common, vd, proofs_file, _ = CIRCUITS[tag][1]()
    with open(os.path.join(FIXTURES, proofs_file)) as f:
        pwp = plonk_proof_from_json(f.readline())
    shape = plonk_proof_shape(common, len(pwp.public_inputs))
    batch = load_plonk_proofs([pwp], shape, vd)
    return profiling.profile_verifier(build_plonk_verifier(common, vd), batch)


CONFIGS = {
    "gl_n32": ("fib_stark_n32.json", lambda: _fib("fib_stark_n32.json")),
    "gl_n2048": ("fib_stark_n2048.json",
                 lambda: _fib("fib_stark_n2048.json")),
    "bn254_caps_n32": ("fib_stark_n32_poseidon_bn254.json",
                       lambda: _fib("fib_stark_n32_poseidon_bn254.json",
                                    "poseidon_bn254")),
    "all_bn254_n32": ("fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz[0]",
                      _all_bn254),
    "plonkish_n32": ("plonkish_n32_x8.jsonl[0]", _plonkish),
    "plonk_fib_small": ("plonk_fib_small_x3.jsonl[0]",
                        lambda: _plonk("fib_small")),
    "plonk_recmix_s60": ("plonk_recmix_s60_x4.jsonl[0]",
                         lambda: _plonk("recmix_s60")),
}


def main():
    out = {}
    for name, (source, census) in CONFIGS.items():
        tree = census()
        out[name] = {"source": source,
                     "totals": {m: tree.root.total(m) for m in METRICS},
                     "tree": tree_json(tree.root)}
        print(name, out[name]["totals"], flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print("wrote", os.path.relpath(OUT, REPO))


if __name__ == "__main__":
    main()
