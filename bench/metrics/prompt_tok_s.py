"""Prompt tokens of every request whose first token came in the window,
over the window's seconds."""
from harness import measure


def read(r):
    return measure.window_prompt_tokens(r) / r.seconds
