"""Entry "walkthrough": the window drives phlash_tpu_torch.fit as docs/torch_example.py calls it.

The walkthrough's step 4 passes the production options: a device mesh and
a checkpoint path (the mix gives steps_per_call, save_every and the
chunking).  On a one-card host make_mesh() makes a world of one rank over
a local store (NCCL on CUDA, gloo on the CPU).  The mesh is made once a
process and serves each of its fits (the warm fit and the window's); each
fit gets a checkpoint file of its own, so that none resumes another's
save, in a directory deleted when the process exits.  The process group
made here is destroyed at exit too, so that the process cannot hang there.
`observe` reads the call's held-out ELPD from fit's frame, as entries/fit.py
does.
"""

from __future__ import annotations

import atexit
import itertools
import os
import tempfile

_state: dict = {}  # this process's mesh and checkpoint directory, made at the first call
_files = itertools.count()


def _destroy_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh_and_path(device: str):
    "(the process's mesh, a fresh checkpoint path in its directory)."
    if not _state:
        import torch.distributed as dist

        from phlash_tpu_torch.parallel import make_mesh

        if not dist.is_initialized():
            atexit.register(_destroy_group)
        _state["mesh"] = make_mesh(device_type=device)
        _state["dir"] = tempfile.TemporaryDirectory(prefix="phlash_bench_ckpt_")
        atexit.register(_state["dir"].cleanup)
    return _state["mesh"], os.path.join(_state["dir"].name, f"fit{next(_files)}.npz")


def call(inputs, seed: int, options: dict, device: str, callback) -> None:
    import phlash_tpu_torch

    mesh, path = _mesh_and_path(device)
    phlash_tpu_torch.fit(inputs.train, test_data=inputs.test, device=device, seed=seed,
                         callback=callback, mesh=mesh, checkpoint_path=path, **options)


def observe(frame) -> dict:
    "The held-out ELPD of the call just made, from fit's frame (None where it is not there)."
    if frame is None or frame.f_code.co_name != "fit":
        return {"elpd": None}
    e = frame.f_locals.get("e")
    return {"elpd": None if e is None else float(e)}
