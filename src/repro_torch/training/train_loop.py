"""train_step factory: gradient accumulation, masked (BRDS) retraining,
and the sharded step (parameter, ZeRO-1 optimizer-state and batch
shardings over a DeviceMesh).

The port of ``repro/training/train_loop.py``: autograd takes the place of
``jax.value_and_grad`` and a Python loop over the microbatches the place of
``lax.scan``.

Shardings are ``sharding.NamedSharding``s (a mesh and DTensor placements)
resolved from each leaf's logical axes by the rule table, as the
reference's are. ``jit_train_step`` runs ``make_train_step``'s math over
them, one process a rank, with the collectives written out (staged
through host memory where gloo carries card tensors,
``dist.collective_ops``):

* each rank holds only its piece of every param (a DTensor laid out by
  ``param_shardings``) and of every moment (``opt_shardings``: ZeRO-1
  splits the moments further over ``data``); no param is gathered whole;
* the forward and backward run tensor-parallel on those pieces
  (``model.with_mesh(mesh)``, ``dist.tensor_parallel``: Megatron's local
  forms, their collectives over ``model`` under autograd), on the rank's
  rows of the batch (split over the batch axes, ``batch_shardings``); a
  rank's loss is weighted by its rows' share of the batch (of its
  masked-in positions under a ``mask``), so the sum over the batch axes is
  the whole batch's mean, and the gradient pieces are all-reduced there;
* the ranks of the other axes hold the same activations; the loss, the
  global norm and the gradients of the leaves they replicate are broadcast
  from the first of them, so every replicated value is bitwise alike on
  every rank even where the card's sums are not deterministic;
* each rank updates its moment pieces, and the updated params are
  all-gathered over ``data`` back to each param's layout.

Every family trains tensor-parallel: the LSTM, and every family of the
zoo (dense, mixture of experts, RG-LRU, RWKV6, encoder-decoder, VLM), its
loss on each rank's vocabulary columns (``TensorParallel.cross_entropy``).
Under a batch ``mask`` the cross-entropy is weighted by a rank's share of
the masked-in positions and the MoE's load-balancing term by its share of
the routing groups (``loss_terms``), so the sum is the whole batch's loss.

DTensor's op-by-op propagation is not used: a vocab-sharded embedding has
no DTensor rule for a batch-sharded index, and gloo on the card takes only
staged collectives.
"""
from __future__ import annotations

import math

import torch

from . import optim
from .tree import leaves, unflatten
from ..sharding import (NamedSharding, mesh_axes, named_sharding,
                        spec_placements, spec_tree)
from ..sparse import apply_masks, mask_grads

__all__ = ["make_train_step", "param_shardings", "zero1_shardings",
           "opt_shardings", "batch_shardings", "jit_train_step",
           "loss_and_grads", "init_sharded", "prune_sharded"]


# ----------------------------------------------------------- shardings

def _axes_and_shapes(model):
    from ..models import layers as L
    defs = model.param_defs()
    axes = (model.param_axes() if hasattr(model, "param_axes")
            else L.param_axes(defs))
    return axes, L.param_shapes(defs)


def param_shardings(mesh, model):
    """Each param's ``NamedSharding`` over ``mesh``, from
    ``model.param_axes()`` (or its ``param_defs()``' axes) through the
    rule table."""
    axes, shapes = _axes_and_shapes(model)
    return spec_tree(mesh, axes, shapes)


def _used_axes(spec) -> set:
    return {a for s in spec
            for a in ((s,) if isinstance(s, str) else (s or ()))}


def zero1_shardings(mesh, param_sh, params_abstract):
    """Optimizer-state shardings: the param's, plus ``data`` on the first
    replicated dim that ``data`` divides (ZeRO-1). ``params_abstract``: a
    tree of anything with a ``shape`` (tensors, ``PSpec``s) matching
    ``param_sh``."""
    sizes = mesh_axes(mesh)
    dsize = sizes.get("data", 1)

    def zspec(sh: NamedSharding, ab) -> NamedSharding:
        shape = tuple(ab.shape)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        if "data" in sizes and "data" not in _used_axes(spec):
            for i, entry in enumerate(spec):
                if entry is None and shape[i] > 0 and shape[i] % dsize == 0:
                    spec[i] = "data"
                    break
        return NamedSharding(mesh, spec_placements(mesh, spec), tuple(spec))

    return unflatten(param_sh, [zspec(sh, ab) for sh, ab in
                                zip(leaves(param_sh),
                                    leaves(params_abstract))])


def opt_shardings(mesh, opt_cfg: optim.OptConfig, param_sh, params_abstract,
                  zero1: bool = True):
    """The optimizer state's shardings: the moments ZeRO-1's (or the
    params' without ``zero1``), ``count`` replicated."""
    moment = (zero1_shardings(mesh, param_sh, params_abstract)
              if zero1 else param_sh)
    scalar = NamedSharding(mesh, spec_placements(mesh, ()), ())
    if opt_cfg.name == "adamw":
        return {"m": moment, "v": moment, "count": scalar}
    return {"m": moment, "count": scalar}


def batch_shardings(mesh, batch_abstract):
    """Each batch leaf split over the batch axes on its first dim."""
    return {k: named_sharding(mesh, ["batch"] + [None] * (len(v.shape) - 1),
                              tuple(v.shape))
            for k, v in batch_abstract.items()}


def init_sharded(mesh, model, opt_cfg: optim.OptConfig, generator,
                 device, zero1: bool = True):
    """(params, opt_state) laid out over ``mesh`` with no whole copy:
    each param drawn as ``model.init`` draws it (the same values) and kept
    as this rank's piece (``param_shardings``), the moments this rank's
    zero pieces (``opt_shardings``), ``count`` replicated."""
    from ..dist.collective_ops import to_dtensor
    from ..models import layers as L
    defs = model.param_defs()
    p_sh = param_shardings(mesh, model)
    o_sh = opt_shardings(mesh, opt_cfg, p_sh, defs, zero1=zero1)
    params = L.init_params(defs, generator, device, shardings=p_sh)

    def zeros(sh, d):
        shape = list(d.shape)
        for i, pl in enumerate(sh.placements):
            if pl.is_shard():
                shape[pl.dim] //= mesh.size(i)
        return to_dtensor(torch.zeros(shape, dtype=torch.float32,
                                      device=device), mesh, sh.placements,
                          d.shape)
    state = {k: (unflatten(defs, [zeros(sh, d) for sh, d in
                                  zip(leaves(v), leaves(defs))])
                 if k != "count" else
                 to_dtensor(torch.zeros((), dtype=torch.int32,
                                        device=device), mesh,
                            v.placements, ()))
             for k, v in o_sh.items()}
    return params, state


def prune_sharded(plan, params):
    """``plan.prune`` of DTensor pieces, one leaf gathered whole at a time
    (its mask is the whole leaf's): (pruned pieces, masks as DTensors of
    the params' layout, ``sparsity_report`` of the whole masks)."""
    from ..dist.collective_ops import full_tensor, shard_local, to_dtensor
    from ..sparse.policy import _map_with_path
    masks, total, pruned = {}, 0, 0

    def one(ps, x):
        nonlocal total, pruned
        if ps not in plan.sites:
            return x
        m = plan._site_mask(plan.sites[ps], full_tensor(x))
        total += m.numel()
        pruned += m.numel() - int(m.sum())
        mp = shard_local(m, x.device_mesh, x.placements)
        masks[ps] = to_dtensor(mp, x.device_mesh, x.placements, m.shape)
        xl = x.to_local()
        return to_dtensor(torch.where(mp, xl, torch.zeros_like(xl)),
                          x.device_mesh, x.placements, x.shape)
    out = _map_with_path(params, one)
    return out, masks, {"prunable_params": total, "pruned": pruned,
                        "sparsity": pruned / max(total, 1)}


# ----------------------------------------------------------- train step

def value_and_grad(loss_fn, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every leaf of ``params``, in each leaf's dtype. A leaf the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def loss_and_grads(model, accum: int, params, batch):
    """(loss, grads) of ``model.loss`` on ``batch``, averaged over
    ``accum`` microbatches (float32 sums, each divided by the count, added
    into one set of accumulators in place, as the reference's scan carries
    one). The grads keep the param dtype (bf16 for bf16 params) at
    ``accum == 1``, as the reference's do; the optimizer promotes to
    float32 itself."""
    if accum == 1:
        return value_and_grad(model.loss, params, batch)

    def mb(i):
        return {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                for k, v in batch.items()}
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves(params)]
    loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for i in range(accum):
        l, g = value_and_grad(model.loss, params, mb(i))
        for a, b in zip(grads, leaves(g)):
            a.add_(b.float() / accum)
        del g
        loss = loss + l / accum
    return loss, unflatten(params, grads)


def make_train_step(model, arch_cfg, opt_cfg: optim.OptConfig, masks=None):
    """Returns train_step(params, opt_state, batch, step) → (params,
    opt_state, metrics). Gradient accumulation over ``arch_cfg.grad_accum``
    microbatches (float32 sums, each divided by the count). With ``masks``
    ({path: bool mask}) the pruned weights' gradients are zeroed before the
    update and the masks applied again after it. Metrics: ``loss``,
    ``grad_norm`` and ``lr``, 0-d tensors. The params returned carry no
    autograd history."""
    accum = max(1, arch_cfg.grad_accum)

    def train_step(params, opt_state, batch, step):
        loss, grads = loss_and_grads(model, accum, params, batch)
        if masks is not None:
            grads = mask_grads(grads, masks)
        new_params, new_opt, metrics = optim.apply_update(
            opt_cfg, params, grads, opt_state, step)
        if masks is not None:
            new_params = apply_masks(new_params, masks)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _paths(tree) -> list:
    """Each leaf's mask path (``sparse``'s "layers/0/w_x"), in ``leaves``
    order."""
    from ..sparse.policy import _map_with_path
    return leaves(_map_with_path(tree, lambda ps, _: ps))


def _narrow_to(x, mesh, frm: NamedSharding, to: NamedSharding):
    """A piece of ``x`` (laid out by ``frm``) cut further to ``to``'s
    layout: the rank's block of each dim ``to`` splits over a mesh axis
    that ``frm`` does not."""
    names = list(mesh_axes(mesh))
    for i, pl in enumerate(to.placements):
        if pl.is_shard() and not frm.placements[i].is_shard():
            n = mesh.size(i)
            per = x.shape[pl.dim] // n
            x = x.narrow(pl.dim, mesh.get_local_rank(names[i]) * per, per)
    return x


def jit_train_step(mesh, model, arch_cfg, opt_cfg: optim.OptConfig,
                   batch_abstract, masks=None, donate: bool = True):
    """The sharded train step over ``mesh`` (``make_train_step``'s
    signature and math; see the module docstring for its collectives).

    Returns train_step(params, opt_state, batch, step) → (params,
    opt_state, metrics). Params and moments come back as DTensors laid out
    by ``param_shardings`` / ``opt_shardings`` (``count`` replicated); the
    step also takes them whole (the same plain tensors on every rank, as
    ``init_state`` makes them) and lays them out itself. ``batch``: the
    global batch, the same on every rank (or DTensors of its pieces);
    with a ``mask`` the loss is the whole batch's masked mean. ``masks``
    ({path: bool mask}, whole or DTensors of the params' layout): pruned
    entries stay exactly 0. Metrics: ``loss``, ``grad_norm`` and ``lr``,
    plain 0-d tensors alike on every rank. ``train_step.grads(params,
    batch)`` gives the step's (loss, gradients) alone, the gradients as
    DTensors in the params' layout. ``donate`` is the reference's buffer
    donation: the step never writes its arguments, and the caller drops
    them."""
    from ..dist.collective_ops import (all_reduce_axis, broadcast_axis,
                                       gather_axis, shard_local, to_dtensor)
    if not hasattr(mesh, "get_group"):
        raise TypeError("jit_train_step runs over a torch.distributed "
                        "DeviceMesh of initialized ranks (launch.mesh."
                        f"make_mesh), not a {type(mesh).__name__}")
    defs = model.param_defs()
    p_sh = param_shardings(mesh, model)
    o_sh = opt_shardings(mesh, opt_cfg, p_sh, defs,
                         zero1=getattr(arch_cfg, "zero1", True))
    b_sh = batch_shardings(mesh, batch_abstract)
    accum = max(1, arch_cfg.grad_accum)
    sizes = mesh_axes(mesh)
    names = list(sizes)
    first = next(iter(b_sh.values()))
    # the axes the batch splits over: the gradients sum there; the ranks
    # of the other axes hold the same activations
    batch_axes = tuple(n for n, pl in zip(names, first.placements)
                       if pl.is_shard())
    rest = tuple(n for n in names if n not in batch_axes and sizes[n] > 1)
    n_batch = math.prod(sizes[a] for a in batch_axes)
    p_flat, m_flat = leaves(p_sh), leaves(o_sh["m"])
    shapes = [tuple(d.shape) for d in leaves(defs)]
    paths = _paths(defs)
    net = model.with_mesh(mesh)
    # the axes each param is split on: its squared norm sums over them
    split_on = [tuple(n for n, pl in zip(names, sh.placements)
                      if pl.is_shard()) for sh in p_flat]

    def piece(x, sh):
        """This rank's piece of ``x`` (whole or a DTensor) under ``sh``."""
        if _is_dtensor(x):
            if tuple(x.placements) != tuple(sh.placements):
                raise ValueError(f"a DTensor placed {x.placements}, the "
                                 f"step wants {sh.placements}")
            return x.to_local()
        return shard_local(x, mesh, sh.placements)

    if masks is not None:
        sh_of = dict(zip(paths, zip(p_flat, m_flat)))
        mask_p = {ps: piece(m, sh_of[ps][0]) for ps, m in masks.items()}
        mask_m = {ps: _narrow_to(m, mesh, *sh_of[ps])
                  for ps, m in mask_p.items()}

    def replicated_on(sh) -> tuple:
        return tuple(n for n in rest
                     if not sh.placements[names.index(n)].is_shard())

    def share(b):
        """This rank's rows' weight in the batch's mean: their share of
        the masked-in positions under a ``mask`` (summed over the batch
        axes), else 1 / the number of equal row groups."""
        dev = next(iter(b.values())).device
        if "mask" not in b:
            return torch.tensor(1.0 / n_batch, dtype=torch.float32,
                                device=dev)
        c = b["mask"].float().sum()
        total = all_reduce_axis(c, mesh, batch_axes)
        return c.clamp_min(1) / total.clamp_min(1)

    def loss_fn(flat, b):
        tree = unflatten(defs, [to_dtensor(x, mesh, sh.placements, shape)
                                for x, sh, shape in zip(leaves(flat), p_flat,
                                                        shapes)])
        terms = getattr(net, "loss_terms", None)
        if terms is None:
            return net.loss(tree, b) * share(b)
        # the cross-entropy weighs the rank's share of the batch (of its
        # masked-in positions under a mask), the MoE's term its routing
        # groups (equal on every rank): the whole batch's term, as one
        # device takes it
        ce, aux = terms(tree, b)
        ce = ce * share(b)
        return ce if aux is None else ce + aux / n_batch

    class _Net:
        loss = staticmethod(loss_fn)

    def reduced(params, batch):
        """(loss, gradient pieces in the params' layout, param pieces):
        the rank's rows through the tensor-parallel loss, each weighted by
        its share of the batch, the gradients summed over the batch axes
        in their own dtype (bf16 gradients in bf16, as the reference keeps
        the param dtype there; float32 accumulators under ``accum > 1``),
        each accumulator dropped as soon as its reduced copy exists."""
        with torch.no_grad():
            mine = unflatten(defs, [piece(x, sh) for x, sh in
                                    zip(leaves(params), p_flat)])
            rows = {k: piece(v, b_sh[k]) for k, v in batch.items()}
        loss, grads = loss_and_grads(_Net, accum, mine, rows)
        grads = leaves(grads)
        with torch.no_grad():
            loss = broadcast_axis(all_reduce_axis(loss, mesh, batch_axes),
                                  mesh, rest)
            flat = []
            for i, sh in enumerate(p_flat):
                g = all_reduce_axis(grads[i], mesh, batch_axes)
                grads[i] = None
                flat.append(broadcast_axis(g, mesh, replicated_on(sh)))
        return loss, flat, leaves(mine)

    def sharded_grads(params, batch):
        """(loss, gradients as DTensors in the params' layout): the
        step's gradients before the masks and the optimizer."""
        loss, grads, _ = reduced(params, batch)
        return loss, unflatten(params, [
            to_dtensor(g, mesh, sh.placements, shape)
            for g, sh, shape in zip(grads, p_flat, shapes)])

    def global_norm(grads):
        sq = {}
        for g, axes in zip(grads, split_on):
            sq[axes] = sq.get(axes, 0) + torch.sum(g.float() * g.float())
        total = sum(all_reduce_axis(v, mesh, axes) for axes, v in sq.items())
        return broadcast_axis(torch.sqrt(total), mesh, rest)

    def train_step(params, opt_state, batch, step):
        loss, grads, mine = reduced(params, batch)
        with torch.no_grad():
            if masks is not None:
                grads = leaves(mask_grads(unflatten(defs, grads), mask_p))
            norm = global_norm(grads)
            # the moments' layout: each param's piece cut further over the
            # ZeRO axis
            cut = [_narrow_to(x, mesh, ps, ms)
                   for x, ps, ms in zip(mine, p_flat, m_flat)]
            state = {k: (unflatten(params, [piece(x, sh) for x, sh in zip(
                         leaves(v), leaves(o_sh[k]))])
                         if k in ("m", "v") else
                         (v.to_local() if _is_dtensor(v) else v))
                     for k, v in opt_state.items()}
            g_cut = [_narrow_to(g, mesh, ps, ms)
                     for g, ps, ms in zip(grads, p_flat, m_flat)]
            new_p, new_s, metrics = optim.apply_update(
                opt_cfg, unflatten(params, cut), unflatten(params, g_cut),
                state, step, norm=norm)
            if masks is not None:
                new_p = apply_masks(new_p, mask_m)
            out = []
            for x, ps, ms, shape in zip(leaves(new_p), p_flat, m_flat,
                                        shapes):
                for i in reversed(range(len(names))):
                    mp = ms.placements[i]
                    if mp.is_shard() and not ps.placements[i].is_shard():
                        x = gather_axis(x, mesh, names[i], mp.dim)
                out.append(to_dtensor(x, mesh, ps.placements, shape))
            new_params = unflatten(params, out)
            new_state = {}
            for k, v in new_s.items():
                if k == "count":
                    new_state[k] = to_dtensor(v, mesh, o_sh[k].placements,
                                              ())
                else:
                    new_state[k] = unflatten(params, [
                        to_dtensor(x, mesh, sh.placements, shape)
                        for x, sh, shape in zip(leaves(v), leaves(o_sh[k]),
                                                shapes)])
            metrics["loss"] = loss
        return new_params, new_state, metrics

    train_step.grads = sharded_grads
    return train_step
