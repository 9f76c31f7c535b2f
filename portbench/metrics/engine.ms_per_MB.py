"""The engine's time per MB: the ``_encode_core`` spans of the window
(routing, then the word pipeline or the raw path and everything the
caller's thread waits for in it), in ms per MB of text."""


def read(obs):
    if not obs["mb"] or not obs["core_s"]:
        return None
    return 1e3 * obs["core_s"] / obs["mb"]
