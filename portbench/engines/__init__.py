"""Engines, one file each, found by the configuration's ``engine.tick``.

Each ``<engine>.py`` exports ``Program(config, traffic, device)``, the port
as the configuration runs it (a ``program.ProgramBase``), and
``Reference(config, traffic, device, fdt=torch.float32)``, the benchmark's
reference with the same surface (a ``refprog.ReferenceBase``). A cell whose
configuration names an engine with no file fails before its set-up.

An engine whose unit is neither a tick nor a boot to agreement also exports
its own ``Session`` (``window.Session``'s surface), ``follow`` and
``compare`` (``check.py``'s); the harness takes each from the engine's file
where it has one, and from ``window.py`` and ``check.py`` where it has not.
"""
