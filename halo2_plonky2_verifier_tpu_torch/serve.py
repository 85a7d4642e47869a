"""Batch verification service: proof JSON in, verdicts out, one JSON line
each way.  The counterpart of `tools/serve.py` (`VerifierService`,
:68-167), request for request; `tools/torch_serve.py` is its command line.

Protocol: one JSON object per input line, one JSON response per output line
(logs go to stderr, see `utils/logging.py`).  Request:

    {"id": "req-1",
     "stark": {"family": "fibonacci" | "plonkish", "num_rows": 32},
     "config": {"num_challenges": 2, "rate_bits": 1, "cap_height": 4,
                "proof_of_work_bits": 16, "num_query_rounds": 84},  # optional
     "hasher": "poseidon_goldilocks" | "poseidon_bn254",            # optional
     "format": "native" | "plonky2",                                # optional
     "proofs": ["<proof json>" or a parsed proof object, ...]}

"native" is the repo's proof JSON (`proof_json.proof_from_json`), "plonky2"
plonky2's serde JSON (`interop.stark_proof_from_plonky2_json`, Goldilocks
hashes only).  Response:

    {"id": "req-1", "verdicts": [true, ...], "batch": N, "compile_s": ...,
     "verify_ms": ...}

or {"error": "..."} for a malformed request, which never stops the service.

Verifiers are cached by (family, num_rows, config, hasher, bucket), the
bucket being the batch padded to a power of two with a real proof; the
verdicts are cut back to the request's count.  `compile_s` is the first
verify at a new key (the kernels' load, or build where `ops/_build.py` has
no library for this checkout yet, and the first run), null afterwards;
`verify_ms` is one verify of the bucket, the verdicts copied to the host.
The service runs on `device` ("cuda" unless the caller asks for "cpu").
"""

import io
import json
import time

from .fixtures import read_docs, tampered
from .interop import READERS
from .models import make_stark
from .stark import build_verifier
from .utils.config import make_config
from .utils.logging import get_logger
from .witness import load_proofs, proof_shape


def _bucket(n):
    b = 1
    while b < n:
        b <<= 1
    return b


class VerifierService:
    def __init__(self, device="cuda"):
        self.device = device
        self._verifiers = {}
        self._warm = set()
        self.log = get_logger(__name__)

    def _verifier(self, key, stark, config, degree_bits, hasher):
        if key not in self._verifiers:
            self.log.info("building verifier for %s", key)
            self._verifiers[key] = build_verifier(stark, config, degree_bits,
                                                  hasher=hasher)
        return self._verifiers[key]

    def handle(self, req):
        stark = make_stark(req["stark"])
        config = make_config(req.get("config"))
        hasher = req.get("hasher", "poseidon_goldilocks")
        fmt = req.get("format", "native")
        if fmt not in READERS:
            raise ValueError(f"unknown proof format: {fmt}")
        proofs = [READERS[fmt](p) for p in req["proofs"]]
        if not proofs:
            return {"id": req.get("id"), "verdicts": []}
        degree_bits = proofs[0].proof.recover_degree_bits(config)
        shape = proof_shape(stark, config, degree_bits, hasher)

        n = len(proofs)
        bucket = _bucket(n)
        padded = proofs + [proofs[0]] * (bucket - n)   # pad with a real proof
        batch = load_proofs(padded, shape, self.device)

        key = (req["stark"].get("family", "fibonacci"),
               req["stark"]["num_rows"], config, hasher, bucket)
        verify = self._verifier(key, stark, config, degree_bits, hasher)
        compile_s = None
        if key not in self._warm:
            t0 = time.monotonic()
            verify(batch).cpu()
            compile_s = round(time.monotonic() - t0, 2)
            self._warm.add(key)
        t1 = time.monotonic()
        verdict = verify(batch)[:n].cpu()
        t2 = time.monotonic()
        return {
            "id": req.get("id"),
            "verdicts": [bool(v) for v in verdict],
            "batch": bucket,
            "compile_s": compile_s,
            "verify_ms": round((t2 - t1) * 1e3, 2),
        }

    def run(self, lines_in, out):
        for line in lines_in:
            line = line.strip()
            if not line:
                continue
            try:
                resp = self.handle(json.loads(line))
            except Exception as e:  # a malformed request must not stop it
                self.log.warn("request failed: %s: %s", type(e).__name__, e)
                resp = {"error": f"{type(e).__name__}: {e}"}
            out.write(json.dumps(resp) + "\n")
            out.flush()


# ----------------------------------------------------------------------------
# The self-test
# ----------------------------------------------------------------------------

# (family, num_rows, hasher, format, fixture file) of the self-test
SELF_TEST = (
    ("fibonacci", 32, "poseidon_goldilocks", "native", "fib_stark_n32_x8.jsonl"),
    ("plonkish", 32, "poseidon_goldilocks", "native", "plonkish_n32_x8.jsonl"),
    ("plonkish", 32, "poseidon_goldilocks", "plonky2",
     "plonkish_n32_x4_plonky2.jsonl"),
    ("fibonacci", 32, "poseidon_bn254", "native",
     "fib_stark_n32_poseidon_bn254_x8.jsonl"),
)


def self_test_requests():
    """One request per SELF_TEST row: a proof, the next one tampered in a
    public input, and a third, so [True, False, True] is expected."""
    reqs = []
    for family, num_rows, hasher, fmt, name in SELF_TEST:
        docs = read_docs(name)
        reqs.append({
            "id": f"self-test {family} n={num_rows} {hasher} {fmt}",
            "stark": {"family": family, "num_rows": num_rows},
            "hasher": hasher, "format": fmt,
            "proofs": [json.dumps(docs[0]),
                       json.dumps(tampered(docs[1], "public_input", fmt)),
                       json.dumps(docs[2])]})
    return reqs


def self_test(device="cuda", out=None):
    """Serve the fixtures through the whole protocol path: every request
    twice (the second time without a build), then a malformed line among
    them.  Raises AssertionError on a wrong answer."""
    svc = VerifierService(device)
    reqs = self_test_requests()
    cached_ms, keys = [], set()
    for req in reqs:
        # the plonky2-format request shares the native one's verifier
        key = (req["stark"]["family"], req["hasher"])
        first, second = svc.handle(req), svc.handle(req)
        for resp in (first, second):
            if resp["verdicts"] != [True, False, True] or resp["batch"] != 4:
                raise AssertionError(f"{req['id']}: {resp}")
        if ((first["compile_s"] is None) != (key in keys)
                or second["compile_s"] is not None):
            raise AssertionError(f"{req['id']}: compile_s {first['compile_s']}"
                                 f", then {second['compile_s']}")
        keys.add(key)
        cached_ms.append(second["verify_ms"])
    stream = io.StringIO()
    svc.run(io.StringIO('{"bad json\n' + json.dumps(reqs[0]) + "\n"), stream)
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    if "error" not in lines[0] or lines[1]["verdicts"] != [True, False, True]:
        raise AssertionError(f"protocol loop: {lines}")
    print(f"serve self-test OK on {device} (cached verify: "
          + ", ".join(f"{ms:.1f}" for ms in cached_ms) + " ms)",
          file=out, flush=True)
