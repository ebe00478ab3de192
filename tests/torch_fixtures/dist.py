"""Run a function on the ranks of a gloo process group on the CPU, one OS
process a rank, for the multi-process tests of the port.

``run_ranks(job, world, tmp_path, *args)`` starts ``world`` processes
(``spawn``: a fresh interpreter, which imports torch and the port, never
JAX), each opens the group through ``tpudet_torch.parallel.
init_distributed`` on a ``file://`` rendezvous under ``tmp_path`` with a
60 s timeout and one CPU thread, calls ``job(rank, world, *args)`` and
saves what it returns with ``torch.save``. The parent waits at most
``RANK_TIMEOUT`` seconds, kills what is left, and returns the ranks'
results in rank order; a rank that fails fails the test with its
traceback. ``Ranks`` starts them and lets the caller work until it
joins them. ``job`` must be importable by module path (defined at the top
level of an importable module, such as this one)."""
import datetime
import multiprocessing
import os
import traceback

RANK_TIMEOUT = 120  # seconds a test waits for its ranks


def _rank_main(job, rank, world, root, backend, args):
    import torch

    from tpudet_torch.parallel import close_distributed, init_distributed
    torch.set_num_threads(1)
    out = os.path.join(root, f'rank{rank}.pt')
    try:
        init_distributed(f'file://{os.path.join(root, "rendezvous")}',
                         world, rank, backend=backend, device='cpu',
                         timeout=datetime.timedelta(seconds=60))
        try:
            result = job(rank, world, *args)
        finally:
            close_distributed()
        torch.save({'result': result}, out)
    except BaseException:
        torch.save({'error': traceback.format_exc()}, out)
        raise


class Ranks:
    """``world`` rank processes running ``job``; ``join()`` waits for
    them (at most ``RANK_TIMEOUT`` seconds, then kills what is left) and
    returns their results in rank order. The caller works meanwhile."""

    def __init__(self, job, world, tmp_path, *args, backend='gloo'):
        self.root = str(tmp_path / f'ranks_{job.__name__}')
        os.makedirs(self.root, exist_ok=True)
        ctx = multiprocessing.get_context('spawn')
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(job, r, world, self.root, backend,
                                        args))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self):
        import torch
        try:
            for p in self.procs:
                p.join(RANK_TIMEOUT)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, p in enumerate(self.procs):
            path = os.path.join(self.root, f'rank{r}.pt')
            saved = torch.load(path, weights_only=False) \
                if os.path.exists(path) else {}
            if 'error' in saved:
                raise AssertionError(f'rank {r} failed:\n{saved["error"]}')
            if p.exitcode != 0 or 'result' not in saved:
                raise AssertionError(f'rank {r} exited with {p.exitcode} '
                                     f'(killed after {RANK_TIMEOUT} s?)')
            results.append(saved['result'])
        return results


def run_ranks(job, world, tmp_path, *args, backend='gloo'):
    """``[job(r, world, *args) for r in range(world)]``, each on its rank
    of a ``world``-process group (gloo)."""
    return Ranks(job, world, tmp_path, *args, backend=backend).join()


# ---------------------------------------------------------------------------
# jobs


def syncbn_job(rank, world, x, dy, weight, bias, eps, momentum):
    """The port's ``BatchNorm2d`` training forward and backward on this
    rank's equal slice of ``x`` (N, C, H, W) and ``dy``."""
    import torch

    from tpudet_torch.models.layers import BatchNorm2d
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    bn = BatchNorm2d(x.shape[1], eps=eps, momentum=momentum)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xs = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xs)
    (y * torch.from_numpy(dy[rows])).sum().backward()
    return dict(y=y.detach().numpy(), dx=xs.grad.numpy(),
                dscale=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.running_mean.numpy(), var=bn.running_var.numpy())


def train_step_job(rank, world, model_cfg, flax_state, opt, ema,
                   accumulation, batches):
    """The port's train step on this rank's shard of each step's batch:
    ``batches`` hold every rank's loader batch, one after the other, so
    rank ``r`` takes rows ``[r*B, (r+1)*B)``. Returns tpudet's leaves of
    the state after the steps, and each step's metrics."""
    import torch

    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.train.optim import YoloSGDConfig
    from tpudet_torch.train.train_state import make_train_step
    from tpudet_torch.utils.flax_import import (train_state_from_flax,
                                                train_state_to_flax)
    model = build_detector(model_cfg)
    opt = YoloSGDConfig(**opt)
    state = train_state_from_flax(flax_state, model, opt)
    step = make_train_step(model, opt, accumulation=accumulation, **ema)
    metrics = []
    for batch in batches:
        n = len(batch['img']) // world
        shard = {k: torch.from_numpy(v[rank * n:(rank + 1) * n])
                 for k, v in batch.items()}
        state, m = step(state, shard)
        metrics.append({k: float(v) for k, v in m.items()})
    return train_state_to_flax(state, model), metrics


def forward_train_job(rank, world, model_cfg, variables, batch):
    """``forward_train`` of a float64 detector on this rank's equal slice
    of ``batch``; its losses, with no gradient."""
    import numpy as np
    import torch

    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.utils.flax_import import load_flax_variables
    model = build_detector(model_cfg)
    load_flax_variables(model, variables)
    model.double().train()
    model.dtype = torch.float64
    n = len(batch['img']) // world
    args = [torch.from_numpy(np.asarray(v[rank * n:(rank + 1) * n]))
            for v in batch.values()]
    with torch.no_grad():
        losses = model.forward_train(*args)
    return {k: float(v) for k, v in losses.items()}


def _half(x, rank, world):
    """This rank's equal slice of every batched array in ``x`` (nested
    tuples and lists of them, or one array)."""
    import numpy as np
    if isinstance(x, (tuple, list)):
        return type(x)(_half(v, rank, world) for v in x)
    n = len(x) // world
    return np.asarray(x[rank * n:(rank + 1) * n])


def head_losses(cases, rank=0, world=1):
    """``{name: losses}`` of each case ``(head cfg, method, args)``: the
    port's head built from the cfg, its loss method called on this rank's
    slice of every argument (all of ``args`` with ``world`` 1)."""
    import torch

    from tpudet_torch.models.builder import _build
    out = {}
    for name, (cfg, method, args) in cases.items():
        head = _build(cfg)
        tensors = _to_torch(_half(args, rank, world))
        with torch.no_grad():
            losses = getattr(head, method)(*tensors)
        out[name] = {k: float(v) for k, v in losses.items()}
    return out


def _to_torch(x):
    import torch
    if isinstance(x, (tuple, list)):
        return type(x)(_to_torch(v) for v in x)
    return torch.from_numpy(x)


def losses_job(rank, world, cases, model_cfg, variables, batch):
    """Each head case's losses (``head_losses``) and a float64
    detector's ``forward_train`` losses on this rank's slice."""
    return (head_losses(cases, rank, world),
            forward_train_job(rank, world, model_cfg, variables, batch))
