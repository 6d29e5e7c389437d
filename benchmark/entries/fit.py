"""Entry "fit": the window drives phlash_tpu_torch.fit, the users' entry point.

`call` runs fit on the cell's inputs with the harness's callback, which fit
calls after every call of steps_per_call iterations with the cloud read
back.  `observe` reads a callback's outputs: the cloud, and the held-out
ELPD fit computed in the call.  fit hands the ELPD to no hook, so it is
read from fit's frame (the callback's caller), where the loop keeps it as
`e` after the call's evaluation; a frame that is not fit's, or has no `e`,
gives None, and the check then fails.
"""

from __future__ import annotations


def call(inputs, seed: int, options: dict, device: str, callback) -> None:
    import phlash_tpu_torch

    phlash_tpu_torch.fit(inputs.train, test_data=inputs.test, device=device, seed=seed,
                         callback=callback, **options)


def observe(frame) -> dict:
    "The held-out ELPD of the call just made, from fit's frame (None where it is not there)."
    if frame is None or frame.f_code.co_name != "fit":
        return {"elpd": None}
    e = frame.f_locals.get("e")
    return {"elpd": None if e is None else float(e)}
