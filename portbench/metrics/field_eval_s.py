"""``field_eval_s``: the window's seconds over the calls it completed (host clock)."""


def read(run):
    return run.window_s / len(run.eval_s) if run.eval_s else None
