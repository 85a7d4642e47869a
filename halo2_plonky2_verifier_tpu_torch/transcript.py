"""The Fiat-Shamir transcript as one sponge run per proof.

`TranscriptSchedule` replays the challenger symbolically (observe clears the
outputs; get_challenge absorbs the pending rate-8 chunks in overwrite mode,
then pops output lanes 7 downward) and records, per permutation step, which
flat input element lands in which rate lane, plus the (step, lane) of every
challenge drawn.  It depends on the proof shape only.  At run time the flat
element stream is gathered into (n_steps, 8, B) chunks and every step runs
through kernel K2 (`ops/transcript_kernels.py`).

`ChallengeRef`, `TranscriptSchedule`, `extract` and `extract_ext` are copies
of `halo2_plonky2_verifier_tpu/transcript.py:31-86,295-301`.
"""

import torch

from .ops import transcript_kernels
from .ops.poseidon import SPONGE_RATE


class ChallengeRef:
    """Coordinates of one drawn challenge in the squeeze outputs."""

    __slots__ = ("step", "lane")

    def __init__(self, step, lane):
        self.step = step
        self.lane = lane


class TranscriptSchedule:
    """Symbolic challenger over element indices instead of values."""

    def __init__(self):
        self.n_elements = 0
        self.steps = []          # list of [slot0..slot7], each int index or None
        self.challenges = []     # ChallengeRef per get_challenge, in order
        self._input = []         # pending element indices
        self._avail = []         # poppable (step, lane) pairs, lane order 0..7

    def observe(self, k):
        """Observe k new stream elements; returns their flat indices."""
        out = list(range(self.n_elements, self.n_elements + k))
        self.n_elements += k
        self._avail.clear()      # outputs invalidated
        self._input.extend(out)
        return out

    def _flush(self):
        for i in range(0, len(self._input), SPONGE_RATE):
            chunk = self._input[i:i + SPONGE_RATE]
            self.steps.append(chunk + [None] * (SPONGE_RATE - len(chunk)))
        step = len(self.steps) - 1
        self._avail = [(step, lane) for lane in range(SPONGE_RATE)]
        self._input.clear()

    def get_challenge(self):
        if self._input:
            self._flush()
        if not self._avail:
            self.steps.append([None] * SPONGE_RATE)  # bare permute
            step = len(self.steps) - 1
            self._avail = [(step, lane) for lane in range(SPONGE_RATE)]
        step, lane = self._avail.pop()               # LIFO: lane 7 first
        ref = ChallengeRef(step, lane)
        self.challenges.append(ref)
        return ref

    def get_n_challenges(self, n):
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self):
        c = self.get_n_challenges(2)
        return (c[0], c[1])


def schedule_tables(schedule, device):
    """(src, mask): (n_steps, 8) int64 element index per rate lane (0 where
    the lane is not overwritten) and (n_steps, 8) int32 overwrite mask."""
    src = [[s if s is not None else 0 for s in step] for step in schedule.steps]
    mask = [[int(s is not None) for s in step] for step in schedule.steps]
    return (torch.tensor(src, dtype=torch.int64, device=device),
            torch.tensor(mask, dtype=torch.int32, device=device))


def run_schedule(schedule, elements):
    """Execute the schedule.  elements: (B, n_elements) int64 in observation
    order.  Returns the squeeze outputs ys, (n_steps, 8, B)."""
    assert len(schedule.steps) > 0
    src, mask = schedule_tables(schedule, elements.device)
    chunks = elements[:, src].permute(1, 2, 0).contiguous()   # (ns, 8, B)
    return transcript_kernels.run_steps_planes(chunks, mask)


def extract(ys, ref):
    """Challenge value at a ChallengeRef: (B,) int64."""
    return ys[ref.step, ref.lane]


def extract_ext(ys, ref_pair):
    return (extract(ys, ref_pair[0]), extract(ys, ref_pair[1]))
