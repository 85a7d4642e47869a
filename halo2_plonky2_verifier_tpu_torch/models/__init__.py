"""The STARK families the verifier serves."""

from .fibonacci import FibonacciStark
from .plonkish import PlonkishStark

FAMILIES = {"fibonacci": FibonacciStark, "plonkish": PlonkishStark}


def make_stark(spec):
    """The STARK of a service request's "stark": {"family", "num_rows"};
    the family defaults to "fibonacci"."""
    family = spec.get("family", "fibonacci")
    if family not in FAMILIES:
        raise ValueError(f"unknown stark family: {family}")
    return FAMILIES[family](spec["num_rows"])
