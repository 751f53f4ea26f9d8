"""A follower rank of the mesh (``parallel/mesh.py``): serving or
training.

``python -m skypilot_tpu_torch.parallel.follower --rank R --shape
SLICE,PP,DP,FSDP,SP,TP --device-type cpu|cuda --store PATH`` is the
process :func:`mesh.make_mesh` starts for each rank above 0. It joins
the process group, then repeats what rank 0 sends, in order:

- ``('new', module, qualname, args, kwargs)``: build that engine (or
  trainer) with ``mesh=`` this rank's mesh on this rank's device (its
  constructor keeps only this rank's shard);
- ``('pretrained', module, qualname, path, dtype, kwargs)``: the same
  from a checkpoint directory;
- ``('call', engine_id, name, args, kwargs)``: call that method of the
  engine (its result is rank 0's to use; the follower drops it);
- ``('close', engine_id)``: drop the engine;
- ``('stop',)``: leave the group and exit.

After each message every rank agrees on whether handling it raised
(``ServingMesh.agree``): an exception that every rank raised alike (a
refusal that depends on the shared host state) is reported and the
follower goes on; any other mix breaks the mesh, and the follower exits
with code 1, so rank 0 raises ``FollowerDied`` instead of waiting on a
peer whose state differs. An idle follower waits for rank 0's next
message for as long as rank 0 lives (rank 0 rings the doorbell with a
no-op, ``('ping',)``, which ``ServingMesh.recv`` drops, well within the
mesh's timeout); when rank 0 dies the follower exits with code 1 (its
doorbell breaks, and a spawned follower also sees its parent go), and
when no ring came within the timeout (rank 0 stalled, its host lost) it
exits with code 1 too. The module imports nothing of JAX and nothing of
the tests, so a spawned child can import it alone.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time
import traceback

import torch


def run(rank: int, spec, device_type: str, store_path: str,
        timeout_s: float, threads) -> None:
    """Join the mesh as ``rank`` and serve rank 0's messages until
    ``('stop',)`` (or until the control channel fails: rank 0 gone)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    if device_type == 'cpu':
        torch.set_num_threads(int(threads or 1))
    _exit_with_parent(rank)
    mesh = mesh_lib.ServingMesh(
        spec, rank, device_type, store_path, timeout_s,
        startup_timeout_s=max(timeout_s, mesh_lib.STARTUP_TIMEOUT_S))
    serve(mesh)


# Seconds between two looks at the parent process.
PARENT_POLL_S = 0.5


def _exit_with_parent(rank: int) -> None:
    """Exit (code 1) as soon as the process that spawned this follower,
    rank 0, is gone: a daemon thread watches the parent pid, so a rank 0
    killed by a signal never leaves its followers waiting."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(PARENT_POLL_S)
        print(f'[mesh rank {rank}] rank 0 (pid {parent}) is gone; '
              'leaving', file=sys.stderr, flush=True)
        os._exit(1)

    threading.Thread(target=watch, name='mesh-parent-watch',
                     daemon=True).start()


def serve(mesh) -> None:
    """Serve rank 0's messages on a follower rank's ``mesh`` until
    ``('stop',)``; a broken mesh exits the process with code 1. The
    mesh's process group is destroyed (aborted when broken) on the way
    out. A mesh gang's follower (``serve/server.py`` ``run_follower``)
    calls this on the mesh :func:`mesh.gang_mesh` built."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    rank = mesh.rank
    try:
        while True:
            msg = mesh.recv()
            if msg[0] == 'stop':
                break
            exc = None
            try:
                _handle(mesh, msg)
            except Exception as e:  # noqa: BLE001 - agreed on below
                exc = e
                print(f'[mesh rank {rank}] {msg[0]} {msg[1:3]} raised:\n'
                      + traceback.format_exc(), file=sys.stderr, flush=True)
            mesh.agree(exc)
    except mesh_lib.FollowerDied as e:
        print(f'[mesh rank {rank}] leaving a broken mesh: {e}',
              file=sys.stderr, flush=True)
        sys.exit(1)
    finally:
        mesh.closed = True
        mesh_lib.abort_broken_group(mesh)


def _handle(mesh, msg) -> None:
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    kind = msg[0]
    if kind == 'new':
        _, module, qualname, args, kwargs = msg
        cls = mesh_lib.resolve(module, qualname)
        cls(*args, mesh=mesh, device=mesh.device, **kwargs)
    elif kind == 'pretrained':
        _, module, qualname, path, dtype, kwargs = msg
        cls = mesh_lib.resolve(module, qualname)
        cls.from_pretrained(path, dtype=dtype, mesh=mesh, device=mesh.device,
                            **kwargs)
    elif kind == 'call':
        _, eid, name, args, kwargs = msg
        getattr(mesh.engines[eid], name)(*args, **kwargs)
    elif kind == 'close':
        mesh.close_engine(msg[1])
    else:
        raise ValueError(f'unknown control message {kind!r}')


def main(argv=None) -> None:
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    ap = argparse.ArgumentParser(description='a mesh follower rank')
    ap.add_argument('--rank', type=int, required=True)
    ap.add_argument('--shape', required=True,
                    help='the mesh axis sizes: slice,pp,dp,fsdp,sp,tp')
    ap.add_argument('--device-type', choices=('cpu', 'cuda'),
                    required=True)
    ap.add_argument('--store', required=True)
    ap.add_argument('--timeout-s', type=float,
                    default=mesh_lib.DEFAULT_TIMEOUT_S)
    ap.add_argument('--threads', type=int, default=1)
    a = ap.parse_args(argv)
    n_slice, pp, dp, fsdp, sp, tp = (int(x) for x in a.shape.split(','))
    run(a.rank, mesh_lib.MeshSpec(dp=dp, fsdp=fsdp, sp=sp, tp=tp,
                                  num_slices=n_slice, pp=pp),
        a.device_type, a.store, a.timeout_s, a.threads)


if __name__ == '__main__':
    main()
