"""Write the BN254 columnar fixtures that the PyTorch port's tests and
`chip_smoke.py` read, with the JAX package's pure-Python prover (no
download, no accelerator):

  tests/fixtures/fib_stark_n2048_poseidon_bn254_x8.npz
      8 distinct FibonacciStark n=2^11 proofs, standard_fast_config,
      Poseidon-BN254 Merkle caps and the Goldilocks transcript (plonky2's
      PoseidonBN128GoldilocksConfig);
  tests/fixtures/fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz
      8 distinct n=2^5 proofs of the all-BN254 configuration (BN254 caps and
      the BN254 sponge transcript).

Each npz holds the leaves of the JAX `ProofBatch` (`witness.save_batch_npz`).
The proofs' JSON caches go to a temporary directory and are not kept.

Usage: JAX_PLATFORMS=cpu python tools/gen_torch_bn254_fixtures.py
(about three minutes on one CPU core, nearly all of it the n=2^11 proofs).
"""

import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from halo2_plonky2_verifier_tpu import load_proofs, proof_shape  # noqa: E402
from halo2_plonky2_verifier_tpu.models.fibonacci import (  # noqa: E402
    FibonacciStark, fibonacci)
from halo2_plonky2_verifier_tpu.refimpl import field as gl  # noqa: E402
from halo2_plonky2_verifier_tpu.refimpl import hashers, prover  # noqa: E402
from halo2_plonky2_verifier_tpu.refimpl.fixtures import \
    get_fibonacci_batch_columnar  # noqa: E402
from halo2_plonky2_verifier_tpu.utils.config import StarkConfig  # noqa: E402
from halo2_plonky2_verifier_tpu.witness import save_batch_npz  # noqa: E402

FIXTURES = os.path.join(REPO, "tests", "fixtures")
COUNT = 8


def bn254_hasher_fold_shape(tmp):
    """n=2^11, BN254 caps, GL transcript: the refimpl fixture factory."""
    name = f"fib_stark_n2048_poseidon_bn254_x{COUNT}.npz"
    get_fibonacci_batch_columnar(2048, COUNT, cache_dir=tmp,
                                 hasher=hashers.BN254)
    shutil.copyfile(os.path.join(tmp, name), os.path.join(FIXTURES, name))
    return name


def all_bn254(num_rows=32):
    """n=2^5, BN254 caps and BN254 transcript, distinct public inputs as
    refimpl/fixtures.py:_prove_one makes them."""
    name = f"fib_stark_n{num_rows}_poseidon_bn254_bn254sponge_x{COUNT}.npz"
    stark = FibonacciStark(num_rows)
    config = StarkConfig.standard_fast_config()
    proofs = []
    for k in range(COUNT):
        x0, x1 = 2 * k + 1, 3 * k + 2
        pis = [x0 % gl.P, x1 % gl.P, fibonacci(num_rows - 1, x0, x1, gl.P)]
        trace = stark.generate_trace(pis[0], pis[1], gl.P)
        proofs.append(prover.prove(stark, config, trace, pis, hashers.BN254,
                                   transcript="poseidon_bn254"))
    degree_bits = proofs[0].proof.recover_degree_bits(config)
    shape = proof_shape(stark, config, degree_bits, "poseidon_bn254")
    save_batch_npz(os.path.join(FIXTURES, name), load_proofs(proofs, shape))
    return name


def main():
    with tempfile.TemporaryDirectory() as tmp:
        for name in (all_bn254(), bn254_hasher_fold_shape(tmp)):
            size = os.path.getsize(os.path.join(FIXTURES, name))
            print(f"wrote tests/fixtures/{name} ({size} bytes)", flush=True)


if __name__ == "__main__":
    main()
