"""How late the open-loop generator issued the window's feeds: the 95th
percentile of (issued - due) over the window's feeds, from the benchmark's
own clock. Near zero below the knee; it grows through the window above it."""


def read(ctx):
    return ctx["window"]["backlog_p95_ms"]
