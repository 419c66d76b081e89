"""Prompt tokens of the requests whose first token reached the host before
the window closed, over the window's seconds (host clock)."""


def read(run):
    w, t = run.window, run.traffic
    done = sum(1 for d in w.done if d <= w.close)
    return done * t["batch"] * t["prompt_len"] / run.seconds or None
