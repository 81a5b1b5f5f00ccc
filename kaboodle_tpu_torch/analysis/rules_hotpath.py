"""KB3xx -- hot-path rules, scoped to the port's tick stack.

The port of ``kaboodle_tpu/analysis/rules_hotpath.py``. These rules only
fire under :data:`HOT_DIRS` (matched on the module path): the JAX list
mapped onto ``kaboodle_tpu_torch/`` -- the tick engines (``phasegraph/``,
``sim/``), their hand kernels' wrappers and the sampling/hashing
primitives (``ops/``), the ensemble (``fleet/``), the warp stack
(``warp/``), the oracle's tensor surfaces, telemetry's on-device halves,
the serve pool, costscope's microbench payloads, the sparse plane and the
concurrency sanitizer. That is the code whose per-tick cost the card
spends: a host sync there stalls the stream once per tick, and an
implicit dtype doubles an ``[N, N]`` resident.
"""

from __future__ import annotations

import ast

from kaboodle_tpu_torch.analysis.core import Finding, Module, rule
from kaboodle_tpu_torch.analysis.reach import expr_tainted, shallow_exprs, walk_with_taint

HOT_DIRS = (
    "kaboodle_tpu_torch/sim/",
    "kaboodle_tpu_torch/ops/",
    "kaboodle_tpu_torch/fleet/",
    "kaboodle_tpu_torch/warp/",
    # The oracle is host-side by design, but its tensor surfaces feed the
    # parity suites that pin bit-exactness; KB301 is reachability-scoped,
    # so its intentional host numpy (not hot) does not fire.
    "kaboodle_tpu_torch/oracle/",
    # telemetry/: the counters and the recorder ring ride inside the tick.
    "kaboodle_tpu_torch/telemetry/",
    # phasegraph/: every engine's per-tick body.
    "kaboodle_tpu_torch/phasegraph/",
    # serve/: the pool's chunk dispatch runs per round for as long as the
    # server lives.
    "kaboodle_tpu_torch/serve/",
    # costscope/: icibench's payloads become the banked collective walls.
    "kaboodle_tpu_torch/costscope/",
    # sparseplane/: the million-peer tick.
    "kaboodle_tpu_torch/sparseplane/",
    # analysis/conc/: the sanitizer's wrappers run inside the serve loop.
    "kaboodle_tpu_torch/analysis/conc/",
)

# Files whose tensors carry the int8/int16/int32/uint32 discipline: the
# JAX list's file names (matched within HOT_DIRS only, so analysis/core.py
# never collides with fleet/core.py).
DTYPE_DISCIPLINE_FILES = (
    "crc32.py", "hashing.py", "kernel.py", "chunked.py", "state.py", "sampling.py",
    "core.py", "stats.py",
    "horizon.py", "leap.py", "runner.py",
    "fingerprint.py", "engine.py", "lockstep.py",
    "counters.py", "recorder.py",
    "exec.py", "blocked.py", "span.py",
    "pool.py",
    "repair.py", "rng.py",
    "icibench.py",
)

# torch constructors whose default dtype is a trap in the discipline files
# (dtype is keyword-only on all of them).
_CONSTRUCTORS = {"torch.zeros", "torch.ones", "torch.empty", "torch.full", "torch.arange"}

# Host copies of a tensor (KB301), as method names on any receiver.
_HOST_METHODS = {"cpu", "numpy", "tolist"}


def _in_hot_dirs(mod: Module) -> bool:
    return any(d in mod.path for d in HOT_DIRS)


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``."""
    args = [*node.args, *(kw.value for kw in node.keywords if kw.arg == "device")]
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and a.args and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True
    return False


@rule(
    "KB301",
    "host sync in the tick hot path",
    """
Inside per-tick code (``reach.py``) under the hot directories: `.cpu()`,
`.numpy()`, `.tolist()`, `.to("cpu")`, `torch.cuda.synchronize()`, or a host
`numpy` call applied to a device value. Each one waits for the card's
stream and copies to the host, once per tick -- at N = 8,192 a stray sync
costs more than the fused kernels save. Keep the work on the device, or
hoist it out of the tick. Host numpy on Python values (tables built at
import, shape arithmetic) does not fire.
""",
)
def check_hot_host_sync(mod: Module) -> list[Finding]:
    if not _in_hot_dirs(mod):
        return []
    out: list[Finding] = []
    for info in mod.reach.traced_functions():

        def visit(stmt, tainted, info=info):
            for expr in shallow_exprs(stmt):
                for node in ast.walk(expr):
                    if not isinstance(node, ast.Call):
                        continue
                    hit = None
                    d = mod.dotted(node.func)
                    if d == "torch.cuda.synchronize":
                        hit = "torch.cuda.synchronize()"
                    elif isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_METHODS:
                        hit = f".{node.func.attr}()"
                    elif (isinstance(node.func, ast.Attribute) and node.func.attr == "to"
                          and _to_cpu(node)):
                        hit = '.to("cpu")'
                    elif d and d.startswith("numpy.") and any(
                            expr_tainted(a, tainted)
                            for a in [*node.args, *(kw.value for kw in node.keywords)]):
                        hit = d.replace("numpy.", "np.") + "()"
                    if hit:
                        out.append(Finding(
                            mod.path, "KB301", node.lineno,
                            f"{hit} inside per-tick '{info.qualname}' (a host sync a tick)",
                            f"{info.qualname}.{hit}",
                        ))

        walk_with_taint(info, visit)
    return out


@rule(
    "KB302",
    "dtype-less torch constructor in a dtype-disciplined file",
    """
`torch.zeros/ones/empty/full/arange` without an explicit `dtype=` in one of
the int-discipline files (crc32/hashing/exec/blocked/state/sampling/...).
The implicit default there is a trap twice over: `arange` gives int64 and
`zeros`/`full` float32 (or the fill value's type), so a plane meant to be
int8/int16/int32 silently widens, and a bare int64 index promotes
whatever it meets -- the int16-timer carry bug class. The uint32 hash
paths additionally *require* their word dtype. Spell the dtype.
""",
)
def check_dtypeless_constructor(mod: Module) -> list[Finding]:
    if not (_in_hot_dirs(mod) and mod.path.rsplit("/", 1)[-1] in DTYPE_DISCIPLINE_FILES):
        return []
    out: list[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = mod.dotted(node.func)
        if d not in _CONSTRUCTORS:
            continue
        if not any(kw.arg == "dtype" for kw in node.keywords):
            ctor = d.rsplit(".", 1)[-1]
            # One baseline entry covers every instance of that constructor
            # in the file, and stays valid across unrelated edits.
            out.append(Finding(
                mod.path, "KB302", node.lineno,
                f"torch.{ctor}(...) without an explicit dtype in a dtype-disciplined file",
                f"torch.{ctor}",
            ))
    return out
