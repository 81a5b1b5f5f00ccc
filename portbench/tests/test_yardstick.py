"""The frozen byte and operation counts equal ``chip_smoke.py``'s at the launch shapes.

The smoke's counts are read from its source (the ``nbytes = ...`` lines of
``measure`` and its constants) and evaluated at the same shapes: the
benchmark keeps a copy so that a later edit of the smoke cannot move it."""

import ast

import pytest

from portbench import spec, yardstick

SMOKE = spec.ROOT / "chip_smoke.py"


def _smoke():
    tree = ast.parse(SMOKE.read_text())
    consts, nbytes = {}, {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in ("HBM_BYTES_PER_S", "SM_CLOCK_HZ", "OPS_PER_CELL"):
                consts[name] = ast.literal_eval(node.value)
        if isinstance(node, ast.FunctionDef) and node.name == "measure":
            for branch in ast.walk(node):
                if (isinstance(branch, ast.If) and isinstance(branch.test, ast.Compare)
                        and isinstance(branch.test.comparators[0], ast.Constant)):
                    for k, body in ((ast.literal_eval(branch.test.comparators[0]), branch.body),
                                    ("fused_oldest_k", branch.orelse)):
                        for stmt in body:
                            if (isinstance(stmt, ast.Assign)
                                    and getattr(stmt.targets[0], "id", "") == "nbytes"):
                                nbytes.setdefault(k, ast.unparse(stmt.value))
    return consts, nbytes


def test_constants_equal_the_smoke():
    consts, _ = _smoke()
    assert consts["HBM_BYTES_PER_S"] == yardstick.HBM_BYTES_PER_S
    assert consts["SM_CLOCK_HZ"] == yardstick.SM_CLOCK_HZ
    assert consts["OPS_PER_CELL"] == yardstick.OPS_PER_CELL


@pytest.mark.parametrize("name", sorted(yardstick.OPS_PER_CELL))
@pytest.mark.parametrize("n,live,tb", [(8192, 8192, 4), (8192, 7781, 4), (65536, 60000, 2),
                                       (1024, 3, 4)])
def test_bytes_equal_the_smoke(name, n, live, tb):
    _, nbytes = _smoke()
    want = eval(nbytes[name], {}, {"b": n, "n": n, "live": live, "tb": tb, "k": 5})
    assert yardstick.kernel_bytes(name, n, n, live, tb, 5) == want


def test_bound_takes_the_larger_of_bytes_and_operations():
    n = 8192
    by_bytes = yardstick.kernel_bytes("fused_fp_idv", n, n, n, 4) / yardstick.HBM_BYTES_PER_S
    by_ops = yardstick.kernel_ops("fused_fp_idv", n, n, n) / yardstick.INT32_OPS_PER_S
    assert yardstick.bound_s("fused_fp_idv", n, n, n, 4) == max(by_bytes, by_ops)
