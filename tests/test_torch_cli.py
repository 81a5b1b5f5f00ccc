"""The port's command line (``python -m kaboodle_tpu_torch``) against the JAX CLI.

The cases of ``tests/test_cli.py`` through the port (their ``slow``
markers kept, the two-instance live demo included), then: the parser,
``resolve_interface`` and ``format_peer_table`` equal to JAX's; the
``--sim`` and ``--sim-scenario`` JSON lines and their ``--metrics-jsonl``
/ ``--telemetry`` manifests equal to the JAX CLI's on the CPU but for the
time fields; the ``--warp`` line equal to what the port's
``simulate_warped`` gives for the same arguments; every subcommand
routed; ``--sim`` without a card and without ``--device`` refused; the
phasegraph dryrun and its plan lines; and the sweep's manifest equal to
the JAX sweep's.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys

import pytest
import torch

from kaboodle_tpu import cli as jcli
from kaboodle_tpu_torch.cli import build_parser, format_peer_table, main, resolve_interface
from kaboodle_tpu_torch.errors import NoAvailableInterfaces
from kaboodle_tpu_torch.telemetry.manifest import read_manifest
from kaboodle_tpu_torch.transport.native import list_interfaces

CPU = ["--device", "cpu"]
TIME_FIELDS = ("wall_s",)


def run(fn, argv) -> tuple[int, dict, str]:
    """``(rc, last JSON line, stdout)`` of a CLI main."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    out = buf.getvalue()
    return rc, json.loads(out.strip().splitlines()[-1]), out


def untimed(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in TIME_FIELDS}


def manifest(path) -> list[dict]:
    return [untimed(r) for r in read_manifest(str(path))]


# ---------------------------------------------------------------- tests/test_cli.py


def test_parser_flags():
    a = build_parser().parse_args(
        ["--identity", "x", "--port", "7000", "--ping", "1.2.3.4:5", "--ping", "6.7.8.9:1"]
    )
    assert a.identity == "x" and a.port == 7000
    assert a.ping == ["1.2.3.4:5", "6.7.8.9:1"]


def test_resolve_interface():
    ifaces = list_interfaces()
    if not ifaces:
        pytest.skip("no interfaces")
    ip, idx, bcast = resolve_interface(None)  # IPv6-preferred reference policy
    fams = {i["family"] for i in ifaces}
    if 6 in fams:
        assert ":" in ip and bcast == "ff02::1213:1989"
    explicit = resolve_interface(ifaces[0]["ip"])
    assert explicit[0] == ifaces[0]["ip"]
    with pytest.raises(NoAvailableInterfaces):
        resolve_interface("203.0.113.77")


def test_resolve_interface_by_name_and_family_keywords():
    ifaces = list_interfaces()
    if not ifaces:
        pytest.skip("no interfaces")
    named = [i for i in ifaces if i["name"]]
    assert named, "list_interfaces must surface the device name"
    first = named[0]
    ip, idx, _ = resolve_interface(first["name"])
    matches = [i for i in ifaces if i["name"] == first["name"]]
    assert any(i["ip"] == ip and i["ifindex"] == idx for i in matches)
    fams = {i["family"] for i in ifaces}
    if 4 in fams:
        assert resolve_interface("ipv4") == resolve_interface("v4")
    if 6 in fams:
        assert resolve_interface("ipv6") == resolve_interface("v6")
    with pytest.raises(NoAvailableInterfaces):
        resolve_interface("no-such-device0")


def test_format_peer_table():
    out = format_peer_table(
        "1.1.1.1:1",
        {"1.1.1.1:1": ("Known", None), "2.2.2.2:2": ("WaitingForPing", 12.5)},
        {"1.1.1.1:1": b"me", "2.2.2.2:2": b"you"},
    )
    assert "(me)" in out and "WaitingForPing" in out and "12.5ms" in out


@pytest.mark.slow
def test_sim_mode():
    rc, out, _ = run(main, ["--sim", "64", "--ticks", "8", *CPU])
    assert rc == 0 and out["final_converged"] and out["n_peers"] == 64


def test_sim_scenario_mode():
    rc, out, _ = run(main, ["--sim-scenario", "1", "--ticks", "8", *CPU])
    assert rc == 0 and out["n_peers"] == 4


@pytest.mark.slow
def test_two_instance_live_demo():
    """The run2x2 demo shape through ``python -m kaboodle_tpu_torch``: two
    instances find each other and report 2 peers with matching
    fingerprints."""
    v4 = [i for i in list_interfaces() if i["family"] == 4 and i["broadcast"]]
    if not v4:
        pytest.skip("no broadcast-capable IPv4 interface")
    cmd = [
        sys.executable, "-m", "kaboodle_tpu_torch",
        "--interface", v4[0]["ip"], "--port", "18866",
        "--period-ms", "100", "--duration", "5",
    ]
    procs = [
        subprocess.Popen(
            cmd + ["--identity", f"pane-{i}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=60)[0] for p in procs]
    for out in outs:
        assert "self: " in out
        assert "2 peers" in out, out[-500:]
    fps = {
        [ln for ln in out.splitlines() if "fingerprint" in ln][-1].split()[-1]
        for out in outs
    }
    assert len(fps) == 1


def test_cli_dispatches_phasegraph_subcommand(capsys):
    assert main(["phasegraph", "--n", "16", "--ensemble", "2", "--leap", "2", *CPU]) == 0
    out = capsys.readouterr().out
    assert "fused" in out and "warp" in out and '"ok": true' in out


# ---------------------------------------------------------------- against the JAX CLI


def _actions(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.const, a.choices, a.type)
            for a in parser._actions if a.dest != "help"}


def test_parser_equals_the_jax_parser_plus_device():
    want, got = _actions(jcli.build_parser()), _actions(build_parser())
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want
    assert got["device"][:2] == (("--device",), None)


def test_resolve_interface_equals_jax():
    ifaces = list_interfaces()
    if not ifaces:
        pytest.skip("no interfaces")
    specs = [None, "v4", "v6", "ipv4", "ipv6", "203.0.113.77", "no-such-device0"]
    specs += [i["ip"] for i in ifaces] + [i["name"] for i in ifaces if i["name"]]
    for spec in specs:
        try:
            want = jcli.resolve_interface(spec)
        except Exception as e:  # the JAX package's NoAvailableInterfaces
            with pytest.raises(NoAvailableInterfaces):
                resolve_interface(spec)
            assert type(e).__name__ == "NoAvailableInterfaces"
            continue
        assert resolve_interface(spec) == want, spec


@pytest.mark.parametrize("states, peers", [
    ({"1.1.1.1:1": ("Known", None), "2.2.2.2:2": ("WaitingForPing", 12.5)},
     {"1.1.1.1:1": b"me", "2.2.2.2:2": b"you"}),
    ({"10.0.0.9:7475": ("Known", 3, 2.0), "10.0.0.2:7475": ("Suspected", 9, 0)},
     {"10.0.0.2:7475": "text-id"}),
    ({}, {}),
])
def test_format_peer_table_equals_jax(states, peers):
    assert format_peer_table("10.0.0.9:7475", states, peers) == jcli.format_peer_table(
        "10.0.0.9:7475", states, peers)


@pytest.mark.parametrize("argv, out_flag", [
    (["--sim-scenario", "1", "--ticks", "8"], "--metrics-jsonl"),
    (["--sim", "32", "--ticks", "16"], "--telemetry"),
])
def test_sim_json_and_manifest_equal_jax(tmp_path, argv, out_flag):
    jpath, path = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jrc, jline, _ = run(jcli.main, [*argv, out_flag, str(jpath)])
    rc, line, _ = run(main, [*argv, out_flag, str(path), *CPU])
    assert rc == jrc == 0
    assert untimed(line) == untimed(jline)
    assert manifest(path) == manifest(jpath)
    if out_flag == "--telemetry":
        assert "counter_totals" in line and line["counter_totals"]["pings_sent"] > 0
        assert [r["kind"] for r in manifest(path)].count("recorder") == 1


def _warp_expected(n, ticks, memo, telemetry):
    """The port's ``simulate_warped`` for the CLI's ``--sim N --ticks T
    --warp`` arguments, summarized as the CLI summarizes it."""
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim.runner import state_converged
    from kaboodle_tpu_torch.sim.scenario import Scenario
    from kaboodle_tpu_torch.sim.state import init_state
    from kaboodle_tpu_torch.warp.runner import WarpLedger, simulate_warped

    sc = Scenario(n=n, ticks=ticks, seed=0)
    st = init_state(n, seed=0, alive=sc.initial_alive(), device="cpu")
    ledger = WarpLedger()
    res = simulate_warped(st, sc.build(device="cpu"), SwimConfig(), faulty=True,
                          telemetry=telemetry, ledger=ledger, memo=memo)
    final, dense_ticks = res[0], res[1]
    want = {"dense_ticks_executed": int(dense_ticks.size),
            "leaped_ticks": int(ticks - dense_ticks.size),
            "leap_classes": json.loads(json.dumps(
                {str(k): v for k, v in sorted(ledger.per_class().items())})),
            "final_converged": state_converged(final)}
    if telemetry:
        want["counter_totals"] = res[3]
    return want, ledger


@pytest.mark.parametrize("memo_on", [False, True])
def test_warp_line_equals_simulate_warped(tmp_path, monkeypatch, memo_on):
    from kaboodle_tpu_torch.warp import runner
    from kaboodle_tpu_torch.warp.runner import SpanMemo

    n, ticks = 16, 64
    argv = ["--sim", str(n), "--ticks", str(ticks), "--warp", *CPU]
    if memo_on:
        monkeypatch.setattr(runner, "span_memo", SpanMemo())
        path = tmp_path / "warp.jsonl"
        argv += ["--telemetry", str(path)]
    else:
        argv += ["--no-warp-memo"]
    rc, line, _ = run(main, argv)
    want, ledger = _warp_expected(n, ticks, SpanMemo() if memo_on else None, memo_on)
    assert {k: line[k] for k in want} == want
    assert rc == (0 if want["final_converged"] else 2)
    assert line["warp"] and line["warp_hybrid"] and line["warp_mode"] == "exact"
    assert line["leaped_ticks"] > 0 and line["warp_memo"] == memo_on
    if memo_on:
        assert line["warp_memo_stats"]["misses"] > 0
        recs = manifest(path)
        assert [r["kind"] for r in recs].count("warp_spans") == len(ledger.per_class())
        assert [r["kind"] for r in recs].count("warp_blocked") == len(ledger.blocked_histogram())
        assert untimed(recs[0]) == {"schema": recs[0]["schema"], "kind": "run",
                                    "metric": "sim_run", **untimed(line)}


def test_warp_mode_and_hybrid_flags_reach_simulate_warped():
    rc, line, _ = run(main, ["--sim", "16", "--ticks", "48", "--warp", "--no-warp-hybrid",
                             "--no-warp-memo", "--warp-mode", "distributional", *CPU])
    assert rc == 0 and line["warp_hybrid"] is False and line["warp_mode"] == "distributional"
    assert "warp_memo_stats" not in line


@pytest.mark.parametrize("sub, module", [
    ("fleet", "kaboodle_tpu_torch.fleet.bench"),
    ("telemetry", "kaboodle_tpu_torch.telemetry.summary"),
    ("serve", "kaboodle_tpu_torch.serve.server"),
    ("serve-load", "kaboodle_tpu_torch.serve.loadgen"),
    ("fed-load", "kaboodle_tpu_torch.serve.federation.fedload"),
    ("sparse", "kaboodle_tpu_torch.sparseplane.dryrun"),
    ("phasegraph", "kaboodle_tpu_torch.phasegraph.dryrun"),
    ("costscope", "kaboodle_tpu_torch.costscope.cli"),
])
def test_every_subcommand_dispatches(monkeypatch, sub, module):
    import importlib

    seen = []
    monkeypatch.setattr(importlib.import_module(module), "main",
                        lambda argv: seen.append(argv) or 7)
    assert main([sub, "--x", "y"]) == 7
    assert seen == [["--x", "y"]]


def test_costscope_has_no_counterpart(capsys, monkeypatch):
    """``costscope`` once exited 2 here for want of a counterpart; it now
    reaches the port's costscope CLI: ``--help`` exits 0 with its flags,
    and ``--icibench`` with no card and no ``--device`` raises (no CPU
    fallback)."""
    with pytest.raises(SystemExit) as e:
        main(["costscope", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--entry", "--write-baseline", "--no-baseline-growth", "--report", "--walls",
                 "--icibench", "--dryrun", "--repeats", "--device", "--manifest"):
        assert flag in out, flag
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["costscope", "--icibench"])


def test_subcommands_run_through_the_cli(tmp_path):
    """Real runs of the host-side and CPU routes: the sparse dryrun's stat
    leg, and the summarizer's gate on a manifest the CLI wrote."""
    rc, line, _ = run(main, ["sparse", "--skip-smoke", *CPU])
    assert rc == 0 and line["metric"] == "sparse_dryrun" and line["ok"]
    path = tmp_path / "m.jsonl"
    assert run(main, ["--sim", "8", "--ticks", "4", "--telemetry", str(path), *CPU])[0] == 0
    assert main(["telemetry", str(path), "--check"]) == 0
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert main(["telemetry", str(empty), "--check"]) != 0


def test_sim_without_a_card_or_device_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    assert main(["--sim", "8", "--ticks", "2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    proc = subprocess.run([sys.executable, "-m", "kaboodle_tpu_torch", "--sim-scenario", "1"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_phasegraph_plan_lines_equal_jax(capsys):
    from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
    from kaboodle_tpu.phasegraph import build_graph, plan

    graph = build_graph(JaxSwimConfig(deterministic=True), faulty=True)
    want = []
    for mode in ("full", "fused"):
        prog = plan(graph, mode)
        want.append(f"phasegraph: plan {mode}: {len(prog.passes)} passes, "
                    f"{len(prog.pruned)} pruned, ops={','.join(prog.op_names())}")
    assert main(["phasegraph", "--n", "16", "--ensemble", "2", "--leap", "2", *CPU]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln for ln in out if ln.startswith("phasegraph: plan")] == want
    report = json.loads(out[-1])
    assert report["ok"] and report["engines"] == {
        k: "ok" for k in ("chunked", "sharded", "fleet", "fused", "warp", "hybrid",
                          "hybrid_masked")}


def test_fleet_telemetry_writes_the_jax_records(tmp_path):
    from kaboodle_tpu.fleet.bench import main as jax_fleet_main

    sweep = ["--ensemble", "8", "--n", "16", "--sweep", "drop_rate=0:0.3:4", "--max-ticks", "8",
             "--telemetry"]
    # One device on both sides: the unsharded sweep.
    jrc, jline, _ = run(jax_fleet_main, [*sweep, str(tmp_path / "jax.jsonl"), "--platform", "cpu",
                                         "--shard", "none"])
    rc, line, _ = run(main, ["fleet", *sweep, str(tmp_path / "port.jsonl"), *CPU])
    assert rc == jrc == 0
    want = manifest(tmp_path / "jax.jsonl")
    got = manifest(tmp_path / "port.jsonl")
    assert json.dumps(got) == json.dumps(want)
    assert [r["kind"] for r in got] == ["run"] + ["sweep_bucket"] * 4
    assert line["backend"] == "cpu"
