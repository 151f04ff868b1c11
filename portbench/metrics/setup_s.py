"""setup_s (s, host clock): process start to the window's opening: imports,
the kernel libraries' load (the checkout's first run builds them), the
inputs from the seed, the warm-up."""


def read(run):
    return run.setup_s
