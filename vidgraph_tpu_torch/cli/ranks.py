"""The CLI under ``torchrun``: one command on every rank, rank 0's files.

    torchrun --nproc-per-node N -m vidgraph_tpu_torch.cli.main kg ...

Every rank runs the command (SPMD: the serving mesh's searches and
decodes are collectives, so each rank must make the same calls in the
same order), and only rank 0 writes its outputs, persists the graph store
and prints.  A follower rank (``RANK`` > 0 of a ``WORLD_SIZE`` > 1) runs
in a private directory of its own: its path arguments are made absolute,
its ``--output`` lands there, it reads a copy of the config's graph-store
directory (the graphs rank 0 persisted before), and its standard output
is dropped.  The directory is removed when the command ends.  The graph
store's ``persist_dir`` must be relative, as every shipped config has it.

``stream`` and ``serve`` are driven by frames, queries and requests that
reach rank 0 only: rank 0 leads and broadcasts each engine step or
request, the followers run them (``parallel/leader.py``).  A ``serve``
follower copies no graph store: ``args.persist_dir`` names rank 0's, which
it reads, so that ``/v1/retrieve`` finds a graph persisted after the
server started on every rank.  ``--videos`` is not resolved: a follower
opens no video.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from pathlib import Path
from typing import Iterator

_INPUTS = ("config", "video", "vlm_output", "input", "retrieval_schedule",
           "groundtruth")


def follower() -> bool:
    """Whether this process is a rank other than 0 of a launched world."""
    from ..parallel.mesh import rank, world_size

    return world_size() > 1 and rank() > 0


@contextlib.contextmanager
def rank_scope(args) -> Iterator[None]:
    """Run the block as the command of this rank (see the module's
    docstring); a no-op on rank 0 and at a world of one."""
    if not follower():
        yield
        return
    from ..core.config import PipelineConfig

    home = Path.cwd()
    for name in _INPUTS:
        value = getattr(args, name, None)
        if value:
            setattr(args, name, str((home / value).resolve()))
    private = Path(tempfile.mkdtemp(prefix="vidgraph_rank_"))
    if getattr(args, "output", None):
        args.output = str(private / Path(args.output).name)
    persist = Path(PipelineConfig.from_yaml(args.config)
                   .graph_store.persist_dir)
    if persist.is_absolute():
        raise ValueError(f"graph_store.persist_dir {persist} is absolute: "
                         "under torchrun every rank would write it")
    if args.command == "serve":
        args.persist_dir = str(home / persist)
    elif (home / persist).is_dir():
        shutil.copytree(home / persist, private / persist)
    os.chdir(private)
    try:
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            yield
    finally:
        os.chdir(home)
        shutil.rmtree(private, ignore_errors=True)
