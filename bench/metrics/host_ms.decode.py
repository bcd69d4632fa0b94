"""Host milliseconds a decode step spends inside the program's calls
(``kv_cache.append`` and ``attention_decode`` in every layer), from the
benchmark's own spans around each call."""


def read(view):
    steps = view.steps_of("decode")
    if not steps:
        return None
    return 1e3 * sum(s["host_s"] for s in steps) / len(steps)
