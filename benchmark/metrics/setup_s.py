"""Set-up: from process start to the window's first request or step."""


def read(run):
    return run.setup_s
