"""Process pool for ingestion workers, which must never touch the GPU.

Port of phlash_tpu/mp.py:15-30.  Workers do numpy and file work only; the
initializer hides every CUDA device (CUDA_VISIBLE_DEVICES="") before a task
is unpickled, so a worker that imports torch through a task's module can
never open a CUDA context.  The pool is spawn-context: forking a process
that holds a CUDA context or threads is unsafe.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor


def _hide_devices():
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


class CpuProcessPoolExecutor(ProcessPoolExecutor):
    "Spawn-context pool whose workers see no CUDA device."

    def __init__(self, max_workers=None, **kwargs):
        ctx = multiprocessing.get_context("spawn")
        super().__init__(max_workers, initializer=_hide_devices, mp_context=ctx, **kwargs)
