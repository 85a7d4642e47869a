"""Sharded verification over torch.distributed: proofs split over `dp`,
FRI query rounds over `qp` (`mesh.py`), the multi-process runtime
(`distributed.py`) and the CPU dry run of several ranks (`dryrun.py`)."""
