"""The op census: field operations counted per named scope.

Counterpart of `halo2_plonky2_verifier_tpu/utils/profiling.py`, with its API
and names.  While a census is active (`profile`), the ops layers report each
field operation with its lane count, attributed to the innermost `scope`:

  gl_add, gl_mul            ops/goldilocks.py add; mul and square
  bn254_mont_mul            ops/bn254.py mont_mul and mont_mul_limbs
  poseidon_permute          every Goldilocks permutation, one a lane
  poseidon_bn254_permute    every BN254 permutation, one a lane

A permutation site (a kernel wrapper and its plain version alike) records
the permutation analytically (`record_gl_permutations`,
`record_bn254_permutations`) and suspends the census inside, so the CPU and
the card give the same counts.  A count comes from tensor shapes only, never
from values: the census adds no host sync and no launch.

The JAX census traces the verifier without running it (`jax.eval_shape`).
Eager PyTorch has no such trace, so `profile_verifier` runs one verification
while recording.  Eager loops record once per iteration, so `multiplier`
exists for the API only: a loop wrapped in it counts twice.  Use it only
where one call stands for k executions.

Outputs: a nested text report, collapsed-stack lines (flamegraph.pl and
inferno read them) and a self-contained SVG flamegraph.  `scope` also enters
`torch.profiler.record_function`, so `torch.profiler` traces carry the same
names.
"""

import contextlib
import functools
from collections import OrderedDict

import torch

# One Goldilocks permutation (ops/poseidon.py:permute_planes_plain, the
# JAX package's plane permutation) per lane: 8 full rounds of 12 S-boxes
# and 22 partial rounds of one, each S-box x^7 = 4 products (x^2, x^4, x^6,
# x^7); the constant layer adds 12 elements in each of the 30 rounds.  The
# MDS products are small-constant multiplies, which the census does not
# count (`mul_const_small`, as in the JAX package).
GL_PERM_MUL = 4 * (8 * 12 + 22)          # 472
GL_PERM_ADD = 12 * (8 + 22)              # 360
# One BN254 permutation per lane: 8 full rounds of 4 S-boxes and 56 partial
# rounds of one, each S-box x^5 = 3 Montgomery products (x^2, x^4, x^5),
# and in every round the 4 x 4 MDS mix, 16 products.
BN254_PERM_MONT_MUL = 3 * (8 * 4 + 56) + 16 * (8 + 56)   # 1,288

_ACTIVE = None      # the ContextTree recording, if any
_MULTIPLIER = 1     # product of enclosing multipliers


class _Node:
    __slots__ = ("name", "children", "counts")

    def __init__(self, name):
        self.name = name
        self.children = OrderedDict()
        self.counts = {}

    def child(self, name):
        c = self.children.get(name)
        if c is None:
            c = _Node(name)
            self.children[name] = c
        return c

    def total(self, metric):
        t = self.counts.get(metric, 0)
        for c in self.children.values():
            t += c.total(metric)
        return t


class ContextTree:
    """Scope tree with per-scope operation counts."""

    def __init__(self, name="root"):
        self.root = _Node(name)
        self._stack = [self.root]

    def push(self, name):
        self._stack.append(self._stack[-1].child(name))

    def pop(self):
        assert len(self._stack) > 1, "unbalanced scope pop"
        self._stack.pop()

    def record(self, metric, amount):
        c = self._stack[-1].counts
        c[metric] = c.get(metric, 0) + int(amount)

    def report(self, metric="gl_mul"):
        """Nested text report with absolute counts and % of total."""
        total = max(self.root.total(metric), 1)
        lines = []

        def walk(node, depth):
            t = node.total(metric)
            if t == 0 and depth > 0:
                return
            lines.append(f"{'  ' * depth}{node.name:<40} {t:>14,} "
                         f"({100.0 * t / total:5.2f}%)")
            for c in node.children.values():
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    def collapsed(self, metric="gl_mul"):
        """flamegraph.pl / inferno collapsed-stack lines (self cost per
        stack)."""
        lines = []

        def walk(node, prefix):
            stack = f"{prefix};{node.name}" if prefix else node.name
            self_cost = node.counts.get(metric, 0)
            if self_cost:
                lines.append(f"{stack} {self_cost}")
            for c in node.children.values():
                walk(c, stack)

        walk(self.root, "")
        return "\n".join(lines)

    def reversed_tree(self, metric="gl_mul"):
        """The tree with every stack reversed (leaf-up aggregation)."""
        rev = ContextTree(self.root.name)

        def walk(node, path):
            path = path + [node.name]
            self_cost = node.counts.get(metric, 0)
            if self_cost:
                cur = rev.root
                for name in reversed(path[1:]):
                    cur = cur.child(name)
                cur.counts[metric] = cur.counts.get(metric, 0) + self_cost
            for c in node.children.values():
                walk(c, path)

        walk(self.root, [])
        return rev

    def write_collapsed(self, path, metric="gl_mul"):
        with open(path, "w") as f:
            f.write(self.collapsed(metric) + "\n")

    def write_flamegraph_svg(self, path, metric="gl_mul", title=None,
                             width=1200, row_h=18):
        """A minimal self-contained SVG flamegraph."""
        total = max(self.root.total(metric), 1)
        rects = []

        def walk(node, x, depth):
            t = node.total(metric)
            w = width * t / total
            if w < 0.4:
                return
            rects.append((x, depth, w, node.name, t))
            cx = x
            for c in node.children.values():
                walk(c, cx, depth + 1)
                cx += width * c.total(metric) / total

        walk(self.root, 0.0, 0)
        depth_max = max((d for _, d, _, _, _ in rects), default=0)
        height = (depth_max + 2) * row_h + 30
        out = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" font-family="monospace" font-size="11">',
            f'<text x="{width/2}" y="16" text-anchor="middle" font-size="14">'
            f'{title or metric}</text>',
        ]
        palette = ["#e66", "#e86", "#ea6", "#ec6", "#cd5", "#9c5"]
        for (x, d, w, name, t) in rects:
            y = 24 + d * row_h
            label = name if w > 7 * len(name) else name[:max(int(w / 7), 0)]
            out.append(
                f'<g><title>{name} ({t:,} {metric}, {100.0*t/total:.2f}%)'
                f'</title><rect x="{x:.1f}" y="{y}" width="{max(w,0.5):.1f}" '
                f'height="{row_h-2}" fill="{palette[d % len(palette)]}" '
                f'stroke="#fff" stroke-width="0.4"/>'
                f'<text x="{x+2:.1f}" y="{y+row_h-6}">{label}</text></g>')
        out.append("</svg>")
        with open(path, "w") as f:
            f.write("\n".join(out))


# ----------------------------------------------------------------------------
# Recording API used by the ops layers
# ----------------------------------------------------------------------------

def record(metric, amount):
    """Record `amount` of `metric`, scaled by the enclosing multipliers."""
    if _ACTIVE is not None:
        _ACTIVE.record(metric, amount * _MULTIPLIER)


def lanes(*xs):
    """The census lane count of one elementwise op on `xs` (tensors or
    host ints): the largest element count, as the JAX package's `_nelems`
    takes `max` over the operands."""
    return max((x.numel() for x in xs if hasattr(x, "numel")), default=1)


def record_gl_permutations(n):
    """`n` Goldilocks permutations (one a lane)."""
    record("poseidon_permute", n)
    record("gl_mul", GL_PERM_MUL * n)
    record("gl_add", GL_PERM_ADD * n)


def record_bn254_permutations(n):
    """`n` BN254 permutations (one a lane)."""
    record("poseidon_bn254_permute", n)
    record("bn254_mont_mul", BN254_PERM_MONT_MUL * n)


def gl_planes(state, *_):
    """Census of one Goldilocks permutation of each lane of (12, N)."""
    record_gl_permutations(state.shape[-1])


def bn254_planes(state, *_):
    """Census of one BN254 permutation of each lane of (16, N)."""
    record_bn254_permutations(state.shape[-1])


def counted(record_fn):
    """Decorator of a permutation site: `record_fn(*args)` records the
    site's permutations, then the site runs with the census suspended, so
    that a kernel wrapper and its plain version count alike."""
    def wrap(fn):
        @functools.wraps(fn)
        def site(*args, **kwargs):
            if _ACTIVE is None:
                return fn(*args, **kwargs)
            record_fn(*args, **kwargs)
            with suspend():
                return fn(*args, **kwargs)
        return site
    return wrap


@contextlib.contextmanager
def multiplier(k):
    """Scale recorded counts by k (one call standing for k executions)."""
    global _MULTIPLIER
    prev = _MULTIPLIER
    _MULTIPLIER = prev * int(k)
    try:
        yield
    finally:
        _MULTIPLIER = prev


@contextlib.contextmanager
def suspend():
    """Disable recording (inside a site whose cost is recorded
    analytically)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = None
    try:
        yield
    finally:
        _ACTIVE = prev


def active():
    return _ACTIVE is not None


@contextlib.contextmanager
def scope(name):
    """Named census scope; also a `torch.profiler.record_function` span of
    the same name, so profiler traces carry it (a host-side marker: no
    launch, no sync)."""
    tree = _ACTIVE
    if tree is not None:
        tree.push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if tree is not None:
            tree.pop()


@contextlib.contextmanager
def profile(tree=None):
    """Activate op-count recording into `tree` (a new ContextTree if
    None)."""
    global _ACTIVE
    prev = _ACTIVE
    tree = tree or ContextTree()
    _ACTIVE = tree
    try:
        yield tree
    finally:
        _ACTIVE = prev


def profile_verifier(verify_fn, batch):
    """The per-scope op census of `verify_fn(batch)`.  Eager PyTorch cannot
    trace without running, so this runs one verification while recording,
    on the device the batch lies on (the card's kernels or the CPU's plain
    versions; the counts are the same).  Returns the ContextTree."""
    with profile() as tree:
        verify_fn(batch)
    return tree


def count(fn):
    """Decorator form of `scope`, named after the function."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with scope(fn.__name__):
            return fn(*args, **kwargs)

    return wrapped
