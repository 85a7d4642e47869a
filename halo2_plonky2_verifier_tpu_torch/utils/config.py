"""STARK / FRI configuration, mirroring starky::config::StarkConfig and
plonky2::fri::{FriConfig, FriParams}.

A copy of `halo2_plonky2_verifier_tpu/utils/config.py` (pure Python), so
that the port never imports the JAX package; `tests/test_torch_stark.py`
checks that both give the same FRI parameters.
"""

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 1
    cap_height: int = 4
    proof_of_work_bits: int = 16
    # FriReductionStrategy::ConstantArityBits(arity_bits, final_poly_bits)
    reduction_strategy: Tuple[int, int] = (4, 5)
    num_query_rounds: int = 84

    def reduction_arity_bits(self, degree_bits: int) -> List[int]:
        """plonky2 FriReductionStrategy::ConstantArityBits semantics: keep
        folding by 2^arity_bits while the remaining degree exceeds
        final_poly_bits and the folded tree would still be at least cap_height
        deep."""
        arity_bits, final_poly_bits = self.reduction_strategy
        out = []
        db = degree_bits
        while db > final_poly_bits and db + self.rate_bits - arity_bits >= self.cap_height:
            assert db >= arity_bits
            out.append(arity_bits)
            db -= arity_bits
        return out

    def fri_params(self, degree_bits: int) -> "FriParams":
        return FriParams(
            config=self,
            degree_bits=degree_bits,
            reduction_arity_bits=self.reduction_arity_bits(degree_bits),
        )


@dataclass(frozen=True)
class FriParams:
    config: FriConfig
    degree_bits: int
    reduction_arity_bits: List[int] = field(default_factory=list)

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    @property
    def lde_size(self) -> int:
        return 1 << self.lde_bits

    @property
    def final_poly_len(self) -> int:
        return 1 << (self.degree_bits - sum(self.reduction_arity_bits))

    @property
    def total_arities(self) -> int:
        return sum(self.reduction_arity_bits)


@dataclass(frozen=True)
class StarkConfig:
    security_bits: int = 100
    num_challenges: int = 2
    fri_config: FriConfig = field(default_factory=FriConfig)

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig()

    def fri_params(self, degree_bits: int) -> FriParams:
        return self.fri_config.fri_params(degree_bits)


def make_config(cfg):
    """The StarkConfig of a service request's "config" (absent or empty:
    standard_fast_config)."""
    if not cfg:
        return StarkConfig.standard_fast_config()
    fri_keys = ("rate_bits", "cap_height", "proof_of_work_bits",
                "num_query_rounds")
    fri = FriConfig(**{k: cfg[k] for k in fri_keys if k in cfg})
    return StarkConfig(num_challenges=cfg.get("num_challenges", 2),
                       fri_config=fri)
