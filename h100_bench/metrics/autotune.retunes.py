"""autotune.retunes: the retunes ``Session.retunes`` gained in the window
(each is a frame that reported dropped geometry, re-probed)."""


def read(run):
    return float(run.window.retunes)
