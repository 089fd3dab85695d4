"""Set-up: from the harness's start to the window's, on the host clock:
the processes started, the plane warmed up, every user's key drawn and
every user connected and subscribed through the marshal, the warm-up
messages sent."""


def read(run):
    return run.setup_s
