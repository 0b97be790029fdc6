"""The control and the planted faults that `correct` has to catch.

`control` is the program in the next precision below the configuration's
(float32 -> bfloat16, the program's own bfloat16 path); each fault breaks
the timed path underneath the harness, where the answer is produced:

- `altered_answer`: served labels inverted for a few points;
- `half_burst`: a burst's second half answered with the first half's maps
  and labels (half of the batch left out);
- `unchanged_state`: the optimizer leaves the state as it was;
- `half_batch`: the train step sees half of its batch, its mean over the
  rest;
- `altered_loss`: the train step's loss scaled where it is produced.

`apply(name)` returns (config overrides, a patch to call once the program
is imported); the patch changes the program's classes in this process.
"""

from __future__ import annotations

FAULTS = ("control", "altered_answer", "half_burst", "unchanged_state",
          "half_batch", "altered_loss")


def _altered_answer():
    from gndnet_tpu_torch.infer import GroundInferenceEngine

    run_many = GroundInferenceEngine.run_many

    def altered(self, padded, reference=False):
        pred, labels = run_many(self, padded, reference)
        labels = labels.clone()
        labels[..., :64] = 1 - labels[..., :64].abs()
        return pred, labels

    GroundInferenceEngine.run_many = altered


def _half_burst():
    from gndnet_tpu_torch.infer import GroundInferenceEngine

    infer_many = GroundInferenceEngine.infer_many

    def half(self, scans, eager=False):
        out = infer_many(self, scans, eager)
        k = len(out) // 2
        return out[:len(out) - k] + [(m, lab[:len(s)]) for (m, lab), s in
                                     zip(out[:k], scans[len(out) - k:])]

    GroundInferenceEngine.infer_many = half


def _unchanged_state():
    from gndnet_tpu_torch import train

    train.Optimizer.step = lambda self, finite=None: None


def _half_batch():
    from gndnet_tpu_torch import train

    call = train.TrainStep.__call__

    def half(self, state, points, labels):
        k = max(1, len(points) // 2)
        return call(self, state, points[:k], labels[:k])

    train.TrainStep.__call__ = half


def _altered_loss():
    from gndnet_tpu_torch import train

    call = train.TrainStep.__call__

    def altered(self, state, points, labels):
        state, loss = call(self, state, points, labels)
        return state, loss * 1.01

    train.TrainStep.__call__ = altered


_planted: set = set()


def apply(name: str | None) -> tuple:
    """(config overrides, patch or None) of fault `name` (None: sound).
    The patch plants its fault once a process, however often it is
    called, so that runs of many seeds in one process see it once."""
    if name is None or name == "sound":
        return {}, None
    if name == "control":
        return {"compute_dtype": "bfloat16"}, None
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")

    def patch() -> None:
        if name not in _planted:
            _planted.add(name)
            globals()["_" + name]()

    return {}, patch
