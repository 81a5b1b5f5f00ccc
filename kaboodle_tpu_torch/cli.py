"""CLI demo: the reference's demo app (main.rs) plus a simulator front-end.

The port of ``kaboodle_tpu/cli.py``, with the same flags, routes, printed
JSON and exit codes, plus ``--device``.

Real-network mode reproduces main.rs's behavior: join the mesh on a chosen
interface/port, print an event-driven status table of peers (state, latency,
identity) and the mesh fingerprint once per second, update the terminal
title, and support probe mode (discover one member and exit, main.rs:70-84)
and manual ping bootstrap (--ping addr, lib.rs:268-297). It is host code
over ``transport/`` and touches no device.

Sim mode runs one of the benchmark scenarios (or a custom size) on the card
-- or on ``--device`` -- and prints one JSON summary line (exit 0 when the
run ends converged, 2 when not). With no card and no ``--device`` it prints
the error and exits 1: there is no CPU fallback. The subcommands route to
their modules' own parsers::

    python -m kaboodle_tpu_torch --identity my-node       # join the LAN mesh
    python -m kaboodle_tpu_torch --probe                  # find a member, exit
    python -m kaboodle_tpu_torch --sim 4096 --ticks 32    # simulate on the card
    python -m kaboodle_tpu_torch --sim 64 --device cpu    # ... or on the CPU
    python -m kaboodle_tpu_torch --sim-scenario 3         # BASELINE config 3
    python -m kaboodle_tpu_torch fleet --sweep drop_rate=0:0.3:16 --ensemble 1024
    python -m kaboodle_tpu_torch telemetry M.jsonl --check
    python -m kaboodle_tpu_torch serve | serve-load | fed-load | sparse | phasegraph
    python -m kaboodle_tpu_torch costscope [--report | --icibench --dryrun]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kaboodle_tpu_torch.errors import KaboodleError, NoAvailableInterfaces

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kaboodle_tpu_torch", description="SWIM mesh on PyTorch/CUDA: demo CLI"
    )
    # Real-network args (main.rs:38-50).
    p.add_argument("--identity", default=None, help="identity payload for this node")
    p.add_argument(
        "--interface",
        default=None,
        help="interface IP to bind, or 'v4'/'v6' to pick by family (default: "
        "reference policy, IPv6-preferred non-loopback)",
    )
    p.add_argument("--port", type=int, default=7475, help="broadcast/multicast port")
    p.add_argument("--probe", action="store_true", help="discover one member and exit")
    p.add_argument("--probe-timeout", type=float, default=0.0, metavar="S",
                   help="give up probing after S seconds (0 = retry forever "
                        "with the reference's 1s x1.25 backoff)")
    p.add_argument("--ping", action="append", default=[], metavar="ADDR",
                   help="manually ping ADDR after start (repeatable)")
    p.add_argument("--period-ms", type=int, default=1000, help="protocol period")
    p.add_argument("--duration", type=float, default=0.0,
                   help="exit after this many seconds (0 = run until ^C)")
    # Simulator args.
    p.add_argument("--sim", type=int, default=0, metavar="N",
                   help="simulate N peers on the card instead of joining a LAN")
    p.add_argument("--sim-scenario", type=int, default=0, metavar="K",
                   help="run BASELINE config K (1-5) on the card")
    p.add_argument("--ticks", type=int, default=64, help="sim ticks to run")
    p.add_argument("--warp", action="store_true",
                   help="sim mode: fast-forward quiescent tick spans through "
                        "the event-horizon leap engine (kaboodle_tpu_torch.warp) "
                        "-- bit-exact with dense ticking, runs only the "
                        "eventful/dense ticks")
    p.add_argument("--no-warp-hybrid", action="store_true",
                   help="with --warp: disable the hybrid (near-quiescent "
                        "signature class) span programs and fast-forward only "
                        "strictly quiescent spans; the default leaps armed-"
                        "timer drain windows too (bit-exact either way)")
    p.add_argument("--no-warp-memo", action="store_true",
                   help="with --warp: disable the signature-keyed span memo -- "
                        "every span (leaped and dense) then runs instead of "
                        "replaying banked state deltas; results are "
                        "bit-identical either way")
    p.add_argument("--warp-mode", choices=["exact", "distributional"],
                   default="exact",
                   help="with --warp: 'exact' (default) is bit-exact with "
                        "dense ticking; 'distributional' also leaps drain "
                        "seasons whose per-tick draws only shift event "
                        "ARRIVAL ticks (suspicion countdowns, probe "
                        "waits) -- distribution-pinned, not bit-pinned")
    p.add_argument("--telemetry", nargs="?", const="telemetry.jsonl",
                   default=None, metavar="PATH",
                   help="sim mode: run the telemetry build of the tick "
                        "(per-tick ProtocolCounters + flight recorder) and "
                        "write a JSONL run manifest (default: telemetry.jsonl); "
                        "summarize with `python -m kaboodle_tpu_torch "
                        "telemetry PATH`")
    p.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                   help="sim mode: dump per-tick TickMetrics as manifest "
                        "'tick' records to PATH (no telemetry build needed; "
                        "same schema as --telemetry manifests)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="sim mode: torch device (default: the card; 'cpu' to "
                        "run there). Without a card and without this flag a "
                        "sim run fails: there is no CPU fallback")
    return p


def resolve_interface(spec: str | None) -> tuple[str, int, str]:
    """Resolve --interface to (ip, ifindex, broadcast_ip).

    ``spec``: None (reference policy: IPv6-preferred), a family keyword
    ('ipv4'/'ipv6', with 'v4'/'v6' accepted as shorthand), or an explicit IP
    or device name -- the reference resolves the same three forms, matching
    IP or name uncanonicalized in one pass (main.rs:18-36).
    """
    from kaboodle_tpu_torch.transport.native import list_interfaces

    ifaces = list_interfaces()
    if not ifaces:
        raise NoAvailableInterfaces("no non-loopback interface")

    def bcast(i):
        return i["broadcast"] if i["family"] == 4 else "ff02::1213:1989"

    if spec in ("v4", "v6", "ipv4", "ipv6"):
        fam = 4 if spec in ("v4", "ipv4") else 6
        for i in ifaces:
            if i["family"] == fam:
                return i["ip"], i["ifindex"], bcast(i)
        raise NoAvailableInterfaces(f"no {spec} interface")
    if spec:
        for i in ifaces:
            if i["ip"] == spec or i.get("name") == spec:
                return i["ip"], i["ifindex"], bcast(i)
        raise NoAvailableInterfaces(f"interface {spec!r} not found (by ip or name)")
    for i in ifaces:  # IPv6-preferred (networking.rs:12-23)
        if i["family"] == 6:
            return i["ip"], i["ifindex"], bcast(i)
    i = ifaces[0]
    return i["ip"], i["ifindex"], bcast(i)


def format_peer_table(self_addr: str, peer_states: dict, peers: dict) -> str:
    """The per-second status block (main.rs:198-225)."""
    lines = []
    for addr in sorted(peer_states):
        # Real-net entries are (state, latency-in-ms); sim entries are
        # (state, tick, latency-in-ticks) -- latency is last either way, but
        # the unit differs (one tick = one protocol period = 1 s wall).
        entry = peer_states[addr]
        state, latency = entry[0], entry[-1]
        unit = "tk" if len(entry) == 3 else "ms"
        ident = peers.get(addr, b"")
        ident_s = ident.decode("utf-8", "replace") if isinstance(ident, bytes) else str(ident)
        me = " (me)" if addr == self_addr else ""
        lat = f"{latency:7.1f}{unit}" if isinstance(latency, (int, float)) else "        -"
        lines.append(f"  {addr:<28} {state:<22} {lat}  {ident_s}{me}")
    return "\n".join(lines)


# Interactive-mode spinner (main.rs:134-136, 226-244): a braille-dot cycle --
# the standard "dots" spinner -- shown only when stdin is a terminal.
_SPINNER_FRAMES = "⣾⣽⣻⢿⡿⣟⣯⣷"


def _spawn_stdin_reader():
    """Daemon thread feeding stdin chars to a queue (main.rs:247-258): in
    interactive mode, typing anything (terminal line discipline applies, so
    followed by Enter) triggers a full status dump."""
    import queue
    import threading

    # Keystrokes of one operator: drained every protocol period.
    q: "queue.Queue[str]" = queue.Queue()

    def reader() -> None:
        while True:
            ch = sys.stdin.read(1)
            if not ch:  # EOF
                return
            q.put(ch)

    threading.Thread(target=reader, daemon=True).start()
    return q


def _print_status(node, self_addr: str) -> None:
    """Fingerprint + peer table + terminal title (main.rs:179-225)."""
    states = node.peer_states()
    fp = node.fingerprint()
    # Terminal title: "{addr} {n} {fp:08x}" (main.rs:189-192).
    sys.stdout.write(f"\x1b]0;{self_addr} {len(states)} {fp:08x}\x07")
    print(f"{len(states)} peers, fingerprint {fp:08x}")
    print(format_peer_table(self_addr, states, node.peers()))


def run_real(args) -> int:
    from kaboodle_tpu_torch.transport import RealKaboodle, discover_mesh_member

    ip, idx, bcast_ip = resolve_interface(args.interface)

    if args.probe:
        # Probe mode (main.rs:70-84): find one member, print, exit. The
        # default retries forever like the reference's discover_mesh_member
        # (discovery.rs:51-72); --probe-timeout bounds it.
        res = discover_mesh_member(
            args.port, interface_ip=ip, broadcast_ip=bcast_ip, iface_index=idx,
            total_timeout_ms=int(args.probe_timeout * 1000),
        )
        if res is None:
            print("no mesh member found", file=sys.stderr)
            return 1
        addr, identity = res
        print(f"{addr} {identity.decode('utf-8', 'replace')}")
        return 0

    identity = (args.identity or f"kaboodle-{int(time.time())}").encode()
    node = RealKaboodle(
        identity=identity,
        broadcast_port=args.port,
        interface_ip=ip,
        broadcast_ip=bcast_ip,
        iface_index=idx,
        period_ms=args.period_ms,
        ping_timeout_ms=2 * args.period_ms,
        share_age_ms=10 * args.period_ms,
        rebroadcast_ms=10 * args.period_ms,
    )
    node.start()
    node.ping_addrs(args.ping)
    self_addr = node.self_addr()
    print(f"self: {self_addr} on {ip} (port {args.port})")

    # Event-driven output (main.rs:144-225): joins/leaves print as they
    # arrive; the full status block only on fingerprint change or a
    # keypress. The spinner runs only when stdin is a terminal.
    discovery = node.discover_peers()
    departures = node.discover_departures()
    fp_changes = node.discover_fingerprint_changes()
    # Both ends must be terminals: stdin for the dump trigger (don't steal
    # keystrokes a pipeline owns), stdout for the animation (don't corrupt
    # piped/teed output with \r frames).
    spin = sys.stdin.isatty() and sys.stdout.isatty()
    stdin_q = _spawn_stdin_reader() if spin else None
    frame = 0
    deadline = time.time() + args.duration if args.duration else None
    period_s = min(args.period_ms / 1000.0, 1.0)
    try:
        while deadline is None or time.time() < deadline:
            # One smooth spinner rotation per period beats one frame per
            # second (the protocol only does work once a period, the
            # animation shouldn't look like it hung -- main.rs:226-237).
            if spin:
                for _ in range(10):
                    sys.stdout.write(f"\r{_SPINNER_FRAMES[frame]} ")
                    sys.stdout.flush()
                    frame = (frame + 1) % len(_SPINNER_FRAMES)
                    time.sleep(period_s / 10)
            else:
                time.sleep(period_s)
            node.poll_events()

            emitted = False

            def clear_spinner() -> None:
                nonlocal emitted
                if spin and not emitted:
                    sys.stdout.write("\r  \r")  # erase the spinner frame
                    emitted = True

            while discovery:
                addr, ident = discovery.popleft()
                clear_spinner()
                ident_s = ident.decode("utf-8", "replace")
                print(f"+ {addr}" + (f" ({ident_s})" if ident_s else ""))
            while departures:
                clear_spinner()
                print(f"- {departures.popleft()}")
            new_fp = None
            while fp_changes:  # drain: only the newest value matters
                new_fp = fp_changes.popleft()
            dump = False
            if stdin_q is not None:
                while not stdin_q.empty():
                    stdin_q.get_nowait()
                    dump = True
            if new_fp is not None or dump:
                clear_spinner()
                _print_status(node, self_addr)
    except KeyboardInterrupt:
        pass
    finally:
        try:
            # Exit summary: the final fingerprint/table even if the last
            # change predated the last period (keeps interleaved output
            # meaningful and the live test's final lines comparable).
            # Best-effort: never let a dead engine's status dump shadow the
            # exception that actually ended the loop.
            if spin:
                sys.stdout.write("\r  \r")
            _print_status(node, self_addr)
        except Exception:
            pass
        finally:
            if node.is_running:
                node.stop()
            node.close()
    return 0


def run_sim(args) -> int:
    import numpy as np

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim.runner import simulate
    from kaboodle_tpu_torch.sim.scenario import Scenario, baseline_scenario
    from kaboodle_tpu_torch.sim.state import init_state, resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.sim_scenario:
        sc = baseline_scenario(args.sim_scenario, n=args.sim or None,
                               ticks=args.ticks, seed=args.seed)
    else:
        sc = Scenario(n=args.sim, ticks=args.ticks, seed=args.seed)
    state = init_state(sc.n, seed=args.seed, alive=sc.initial_alive(), device=dev)
    telemetry = args.telemetry is not None
    if args.warp:
        # Event-horizon fast-forward: only the dense ticks produce metrics
        # (leaped spans are provably converged/quiet), so the summary reports
        # both counts plus end-state convergence. With --telemetry the
        # leaped spans still contribute counter totals via the closed form
        # (telemetry.counters.leap_counters).
        from kaboodle_tpu_torch.sim.runner import state_converged
        from kaboodle_tpu_torch.warp.runner import WarpLedger, simulate_warped, span_memo

        hybrid = not args.no_warp_hybrid
        memo = None if args.no_warp_memo else span_memo
        ledger = WarpLedger()
        t0 = time.perf_counter()
        if telemetry:
            final, dense_ticks, stacked, totals = simulate_warped(
                state, sc.build(device=dev), SwimConfig(), faulty=True, telemetry=True,
                hybrid=hybrid, ledger=ledger, memo=memo,
                warp_mode=args.warp_mode,
            )
            m = stacked.metrics if stacked is not None else None
            counters = stacked.counters if stacked is not None else None
        else:
            final, dense_ticks, m = simulate_warped(
                state, sc.build(device=dev), SwimConfig(), faulty=True,
                hybrid=hybrid, ledger=ledger, memo=memo,
                warp_mode=args.warp_mode,
            )
            counters = totals = None
        final_conv = state_converged(final)
        wall = time.perf_counter() - t0
        per_class = ledger.per_class()
        out = {
            "n_peers": sc.n,
            "ticks": sc.ticks,
            "warp": True,
            "warp_hybrid": hybrid,
            "warp_mode": args.warp_mode,
            "warp_memo": memo is not None,
            "dense_ticks_executed": int(dense_ticks.size),
            "leaped_ticks": int(sc.ticks - dense_ticks.size),
            "leap_classes": {
                str(key): agg for key, agg in sorted(per_class.items())
            },
            "final_converged": final_conv,
            "wall_s": round(wall, 3),
        }
        if memo is not None:
            ms = memo.stats()
            out["warp_memo_stats"] = {
                "hits": ms["hits"], "misses": ms["misses"],
                "entries": ms["entries"], "bytes": ms["bytes"],
                "evictions": ms["evictions"],
                "hit_rate": round(ms["hit_rate"], 4),
            }
        if totals is not None:
            out["counter_totals"] = totals
        _write_sim_manifests(args, out, m, counters, ticks=dense_ticks,
                             warp_ledger=ledger)
        print(json.dumps(out))
        return 0 if out["final_converged"] else 2
    t0 = time.perf_counter()
    counters = recorder = None
    if telemetry:
        from kaboodle_tpu_torch.sim.runner import simulate_with_telemetry
        from kaboodle_tpu_torch.telemetry import counters_totals

        final, m, counters, recorder = simulate_with_telemetry(
            state, sc.build(device=dev), SwimConfig(),
            recorder_len=min(32, max(1, sc.ticks)),
        )
    else:
        final, m = simulate(state, sc.build(device=dev), SwimConfig())
    conv = m.converged.cpu().numpy()
    wall = time.perf_counter() - t0
    first = int(np.argmax(conv)) if conv.any() else -1
    out = {
        "n_peers": sc.n,
        "ticks": sc.ticks,
        "first_converged_tick": first,
        "final_converged": bool(conv[-1]),
        "final_agree_fraction": float(m.agree_fraction[-1].item()),
        "messages_delivered": int(m.messages_delivered.sum().item()),
        "wall_s": round(wall, 3),
    }
    if counters is not None:
        out["counter_totals"] = counters_totals(counters)
    _write_sim_manifests(args, out, m, counters, recorder=recorder)
    print(json.dumps(out))
    return 0 if out["final_converged"] else 2


def _write_sim_manifests(args, out, metrics, counters, ticks=None,
                         recorder=None, warp_ledger=None) -> None:
    """The sim lane's manifest outputs (telemetry/manifest.py schema).

    ``--telemetry PATH`` gets the full manifest: a ``run`` record (the same
    summary dict the CLI prints), per-tick records with counters, and the
    flight-recorder dump -- plus, for warped runs, one ``warp_spans``
    record per signature class (the per-class leap counters the
    summarizer aggregates) and one ``warp_blocked`` record per blocking
    term combo (the why-dense histogram). ``--metrics-jsonl PATH`` gets
    metrics-only ``tick`` records -- the lightweight lane that needs no
    telemetry build. Both may be given; they are independent files.
    """
    if args.metrics_jsonl is None and args.telemetry is None:
        return
    from kaboodle_tpu_torch.telemetry.manifest import ManifestWriter

    if args.telemetry is not None:
        with ManifestWriter(args.telemetry) as w:
            w.write("run", metric="sim_run", **out)
            if metrics is not None:
                w.write_tick_metrics(metrics, counters=counters, ticks=ticks)
            if recorder is not None:
                w.write_recorder(recorder)
            if warp_ledger is not None:
                for key, agg in sorted(warp_ledger.per_class().items()):
                    w.write("warp_spans", class_key=int(key), **agg)
                # Why-dense attribution: one record per blocking term combo
                # (pseudo-terms 'scheduled_event' / 'short_span' included).
                for term, agg in sorted(warp_ledger.blocked_histogram().items()):
                    w.write("warp_blocked", term=term, **agg)
        print(f"telemetry manifest: {args.telemetry}", file=sys.stderr)
    if args.metrics_jsonl is not None and metrics is not None:
        with ManifestWriter(args.metrics_jsonl) as w:
            w.write_tick_metrics(metrics, ticks=ticks)
        print(f"metrics manifest: {args.metrics_jsonl}", file=sys.stderr)


# The subcommands: each routes to its module's own ``main`` (imported on
# use), so the flag surfaces of the demo app and of each tool stay apart.
SUBCOMMANDS = {
    "fleet": "kaboodle_tpu_torch.fleet.bench",  # the ensemble sweep
    "telemetry": "kaboodle_tpu_torch.telemetry.summary",  # manifest summarizer, host only
    "serve": "kaboodle_tpu_torch.serve.server",  # lane-pool server (--dryrun: the CI exercise)
    "serve-load": "kaboodle_tpu_torch.serve.loadgen",  # its load driver
    "fed-load": "kaboodle_tpu_torch.serve.federation.fedload",  # two engines + the router
    "sparse": "kaboodle_tpu_torch.sparseplane.dryrun",  # blocked-sparse engine dryrun
    "phasegraph": "kaboodle_tpu_torch.phasegraph.dryrun",  # every engine vs the dense tick
    "costscope": "kaboodle_tpu_torch.costscope.cli",  # cost records, gate, roofline, microbench
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        import importlib

        return importlib.import_module(SUBCOMMANDS[argv[0]]).main(argv[1:])
    args = build_parser().parse_args(argv)
    try:
        if args.sim or args.sim_scenario:
            return run_sim(args)
        return run_real(args)
    except KaboodleError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
