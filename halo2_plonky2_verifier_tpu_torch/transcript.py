"""The Fiat-Shamir transcript as one sponge run per proof.

`TranscriptSchedule` replays the challenger symbolically (observe clears the
outputs; get_challenge absorbs the pending rate-8 chunks in overwrite mode,
then pops output lanes 7 downward) and records, per permutation step, which
flat input element lands in which rate lane, plus the (step, lane) of every
challenge drawn.  It depends on the proof shape only.  At run time the flat
element stream is gathered into (n_steps, 8, B) chunks and every step runs
through kernel K2 (`ops/transcript_kernels.py`).

`BN254TranscriptSchedule` is the same replay for the Poseidon-BN254 sponge
(absorb chunks of 9 Goldilocks elements packed 3 per Fr into slots 1..3, 15
outputs per permutation); `run_schedule_bn254` runs it with kernel K6 once
per step (`ops/bn254_kernels.py`), as the JAX package runs its Pallas
permutation once per step.

`ChallengeRef`, `TranscriptSchedule`, `BN254TranscriptSchedule`, `extract`
and `extract_ext` are copies of `halo2_plonky2_verifier_tpu/transcript.py:
31-86,148-207,295-301`.
"""

import torch

from .ops import bn254 as fr
from .ops import bn254_kernels, transcript_kernels
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


class BN254TranscriptSchedule:
    """Symbolic BN254-sponge challenger over element indices, mirroring
    refimpl.challenger.BN254Challenger:

      - absorb steps take chunks of RATE*3 = 9 GL elements, packed 3-per-Fr
        into state slots 1..3 (partial chunks overwrite only covered slots;
        missing GL inside a covered slot pack as zero);
      - each permute step exposes 15 GL outputs (RATE Fr x 5 56-bit limbs),
        popped LIFO."""

    RATE_GL = 9
    OUT_GL = 15

    def __init__(self):
        self.n_elements = 0
        self.steps = []          # list of [idx0..idx8], int index or None
        self.challenges = []     # ChallengeRef(step, limb 0..14)
        self._input = []
        self._avail = []

    def observe(self, k):
        out = list(range(self.n_elements, self.n_elements + k))
        self.n_elements += k
        self._avail.clear()
        self._input.extend(out)
        return out

    def _flush(self):
        for i in range(0, len(self._input), self.RATE_GL):
            chunk = self._input[i:i + self.RATE_GL]
            self.steps.append(chunk + [None] * (self.RATE_GL - len(chunk)))
        step = len(self.steps) - 1
        self._avail = [(step, limb) for limb in range(self.OUT_GL)]
        self._input.clear()

    def get_challenge(self):
        if self._input:
            self._flush()
        if not self._avail:
            self.steps.append([None] * self.RATE_GL)     # bare permute
            step = len(self.steps) - 1
            self._avail = [(step, limb) for limb in range(self.OUT_GL)]
        step, limb = self._avail.pop()                   # LIFO
        ref = ChallengeRef(step, limb)
        self.challenges.append(ref)
        return ref

    def get_n_challenges(self, n):
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self):
        c = self.get_n_challenges(2)
        return (c[0], c[1])


def run_schedule_bn254(schedule, elements):
    """Execute a BN254TranscriptSchedule.  elements: (B, n_elements) int64
    in observation order.  Returns ys, (n_steps, 15, B): per step the three
    rate slots' 56-bit limbs (slot-major), compatible with `extract`.

    The absorbed chunks are packed and converted to Montgomery form for all
    steps at once; each step then overwrites the slots its chunk covers (Fr
    slot j iff the chunk covers position 3j) and runs kernel K6 on the
    (16, B) state; the outputs leave Montgomery form together at the end."""
    n_steps = len(schedule.steps)
    assert n_steps > 0
    dev = elements.device
    b = elements.shape[0]
    present = [[s is not None for s in step] for step in schedule.steps]
    src = torch.tensor([[s if s is not None else 0 for s in step]
                        for step in schedule.steps], device=dev)
    pm = torch.tensor(present, device=dev)
    chunks = torch.where(pm, elements[:, src], 0)          # absent GL pack as 0
    packed = torch.nn.functional.pad(chunks.reshape(b, n_steps, 3, 3),
                                     (0, 1))               # (B, ns, 3, 4) std
    slots = fr.to_mont(packed).permute(1, 2, 3, 0)         # (ns, 3, 4, B)

    state = torch.zeros((16, b), dtype=torch.int64, device=dev)
    outs = []
    for s in range(n_steps):
        rows = [state[0:4]]
        for j in range(3):
            covered = present[s][3 * j]
            rows.append(slots[s, j] if covered else state[4 + 4 * j:8 + 4 * j])
        state = bn254_kernels.permute_planes(torch.cat(rows).contiguous())
        outs.append(state[:12])
    out = torch.stack(outs)                                 # (ns, 12, B) mont
    words = out.reshape(n_steps, 3, 4, b).permute(0, 3, 1, 2)   # (ns,B,3,4)
    limbs = fr.to_goldilocks_56(fr.from_mont(words))         # (ns,B,3,5)
    return limbs.reshape(n_steps, b, 15).permute(0, 2, 1).contiguous()


def extract(ys, ref):
    """Challenge value at a ChallengeRef: (B,) int64."""
    return ys[ref.step, ref.lane]


def extract_ext(ys, ref_pair):
    return (extract(ys, ref_pair[0]), extract(ys, ref_pair[1]))
