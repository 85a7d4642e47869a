"""Batched plonky2 PLONK and starky STARK proof verification in PyTorch,
with CUDA kernels written for NVIDIA Hopper (sm_90a).

The port of `halo2_plonky2_verifier_tpu` (JAX/Pallas), which stays beside it
as the reference.  This package imports torch and numpy and never jax: a
Goldilocks element is one int64 lane holding the u64 bit pattern, a BN254
element four such words, and the nine Pallas kernels of the JAX package and
its tools (Goldilocks and BN254 Merkle paths and leaf hashes, the Goldilocks
transcript, the BN254 permutation, the bulk and chained Goldilocks
permutations, the BN254 component probes) are CUDA kernels in `ops/csrc/`,
built with nvcc at first use.  The bulk Goldilocks hashing API is
`ops/poseidon.py` (`permute`, `absorb`, `hash_no_pad`, `two_to_one`).

Public API:
    build_verifier(stark, config, degree_bits, check_vanishing=True,
                   hasher=..., query_shard=None, transcript=...)
        -> verify(batch) -> (B,) bool; hasher and transcript are each
        "poseidon_goldilocks" (default) or "poseidon_bn254"
    witness.proof_shape / witness.load_batch_npz / witness.batch_from_numpy
    witness.load_proofs(proofs, shape, device="cuda"): proofs read from JSON
        by proof_json.proof_from_json (the repo's format) or
        interop.stark_proof_from_plonky2_json (plonky2's serde JSON)
    plonk.build_plonk_verifier(common, verifier_data) -> verify(batch);
        circuit.load_circuit(path) -> (common, verifier_data, doc);
        plonk.load_plonk_proofs(proofs, shape, verifier_data, device="cuda")
    StarkConfig.standard_fast_config()
    models.fibonacci.FibonacciStark, models.plonkish.PlonkishStark
    serve.VerifierService(device="cuda"): the JSONL verification service
        (`tools/torch_serve.py` on the command line)
    parallel.mesh.make_mesh / shard_batch / sharded_verifier and
        parallel.distributed: proofs over dp, FRI query rounds over qp, on
        torch.distributed process groups
"""

from .plonk import (PlonkProofBatch, PlonkProofShape, build_plonk_verifier,
                    load_plonk_proofs, plonk_proof_shape)
from .stark import build_verifier
from .utils.config import FriConfig, FriParams, StarkConfig
from .witness import (ProofBatch, ProofShape, batch_from_numpy, load_batch_npz,
                      load_proofs, proof_shape)

__all__ = [
    "build_plonk_verifier",
    "load_plonk_proofs",
    "load_proofs",
    "plonk_proof_shape",
    "PlonkProofBatch",
    "PlonkProofShape",
    "build_verifier",
    "FriConfig",
    "FriParams",
    "StarkConfig",
    "ProofBatch",
    "ProofShape",
    "batch_from_numpy",
    "load_batch_npz",
    "proof_shape",
]
