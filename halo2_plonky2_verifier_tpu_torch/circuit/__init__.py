"""plonky2 PLONK circuit data for the verifier: the circuit's common data
and verifier data rebuilt from a fixture (`common.py`), the gate
constraint evaluators (`gates.py`) and the vanishing terms at zeta
(`vanishing.py`)."""

from .common import (CircuitConfig, CommonCircuitData, LutMeta,
                     VerifierCircuitData, circuit_from_json, circuit_to_json,
                     compute_circuit_digest, load_circuit)

__all__ = ["CircuitConfig", "CommonCircuitData", "LutMeta",
           "VerifierCircuitData", "circuit_from_json", "circuit_to_json",
           "compute_circuit_digest", "load_circuit"]
