"""setup_s: seconds from the process's start to the window's (imports,
weights, traffic, kernel build, warm-up, graph capture). Host clock."""


def read(run):
    return run["setup_s"]
