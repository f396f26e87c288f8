"""setup_s: seconds from the process's start to the window's: imports, the
CUDA context, data, model, kernel build or load, the first steps and the
warm-up (host clock)."""


def read(ctx):
    return ctx["setup_s"]
