"""The benchmark's plain reference of the simulated SWIM protocol.

Plain PyTorch, written for this benchmark and frozen with it: it imports
nothing of the measured program (``kaboodle_tpu_torch``) and nothing of JAX,
and it takes nothing the program made. ``dense.make_tick`` is the tick over
whole ``[N, N]`` planes, ``blocked.make_blocked_tick`` the same protocol
in row blocks with per-block matrix draws, ``runs.converge_loop`` the loop
to fingerprint agreement, and ``state.init_state`` a fresh mesh.
"""
