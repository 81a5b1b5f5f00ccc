"""keyscope's registry half: the port's pinned ``STREAM_*`` table (KB602)."""
