"""The facade's time per MB: each call's wall time less the engine's
``_encode_core`` span inside it (the per-document lists of
``TorchTokenizer.encode_batch`` and the facade around them), summed over
the window, in ms per MB of text."""


def read(obs):
    if not obs["mb"]:
        return None
    return 1e3 * (obs["call_s"] - obs["core_s"]) / obs["mb"]
