"""setup_s: from the process's start to the first timed run (host clock):
imports, the kernel library (built in a checkout's first run), the graphs'
tables, the backend's staging and capture, and the warm runs."""


def read(ctx):
    return ctx.setup_s
