"""tasks_per_s: the tasks of every graph run the window completed, over the
time from the first run's start to the last run's end (host clock)."""


def read(ctx):
    return ctx.window.tasks / ctx.window.seconds
