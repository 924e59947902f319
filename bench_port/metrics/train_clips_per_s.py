"""train_clips_per_s: clips of the optimizer steps completed in the window
(it ends with a synchronize), over the window's seconds. Host clock."""


def read(run):
    return run["steps"] * run["batch"] / run["window_s"] if "steps" in run else None
