"""The primitive narrowphase (spheres, capsules, boxes): the hand-written
CUDA kernel (``csrc/primitive_narrowphase.cu``) and its plain PyTorch
version.

A query of :class:`~trajopt_tpu_torch.collision.world.CollisionScene`
(``distances``, ``distances_and_jac``, ``swept_distances``,
``swept_distances_and_jac``) hands its primitive groups to :func:`query`:
every (kind, kind) group that is not a convex or SDF group, given the link
poses (``tree.fk`` / ``tree.fk_with_axes``) of one or two endpoints and the
scene's ``params``.  :func:`query` writes each group's signed distances
and, when asked, its joint-space Jacobians straight into the query's
outputs in pair order.

Counterpart of the per-pair functions inside
``trajopt_tpu/collision/world.py`` (``swept_distances_and_jac`` :969,
``swept_distances`` :955, ``distances_and_jac`` :711, ``distances`` :665)
over ``trajopt_tpu/collision/geometry.py``, which have no Pallas source:
XLA fuses them on the TPU.

The plain version (:func:`discrete_plain`, :func:`moving_plain`,
:func:`static_plain`, one group each; :func:`query_plain`, every group of a
query) is the autograd code: each group's kernel on the whole batch, and
``torch.autograd.grad`` of the sum of its outputs for every pair's own
link-pose gradient, composed through the geometric-Jacobian relations
(:func:`compose_pose_grads`).

The kernel route (:func:`query_cuda`) launches one kernel a group whose
key is in :data:`KEYS`, back to back on the current stream: one
instantiation a key, one thread a query (lane, gap, sub-segment, pair), or
four lanes a query for a capsule swept against static geometry (one a
segment).  The kernel differentiates in forward mode: the world points of
one side carry tangents, and since a distance is unchanged when both
sides move together, the other side's twist gradient is the negative of
the first's.  The keys it does not take (box-box, in
every mode) run the plain version on the card, by key and never on
failure.

Dispatch (:func:`query`): CPU tensors take the plain version; CUDA tensors
launch the kernel (or raise); meta tensors (a problem checks its terms'
row counts on them) leave the outputs' shapes as they are; any other
device raises.  The kernel is built with ``nvcc`` for ``sm_90a`` at first
use into ``trajopt_tpu_torch/_build/``, with ``--fmad=false`` so that its
values round as the plain version's unfused torch ops do, and bound with
``ctypes``.  The same device functions compiled as host C++
(``csrc/primitive_host.cpp``, ``g++ -ffp-contract=off``) serve the CPU
tests through :func:`query_host`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from trajopt_tpu_torch import kernels
from trajopt_tpu_torch.collision import geometry as geom
from trajopt_tpu_torch.collision.fused_convex import _batch_layout
from trajopt_tpu_torch.kinematics.transforms import matvec
from trajopt_tpu_torch.utils import profiling

SPHERE, CAPSULE, BOX = "sphere", "capsule", "box"
SOURCE = kernels.CSRC / "primitive_narrowphase.cu"
HOST_SOURCE = kernels.CSRC / "primitive_host.cpp"
FLAGS = [*kernels.NVCC_FLAGS, "--fmad=false"]
HOST_FLAGS = ["-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"]
KERNEL = "primitive_narrowphase_kernel"   # each instantiation's profile name
RANGE = "collision.primitive"             # the span of a query
MODES = ("pairs", "moving", "static")     # discrete; swept, both moving;
#                                           swept against static geometry
_KIND = {SPHERE: 0, CAPSULE: 1, BOX: 2}
_DISCRETE = frozenset({(SPHERE, SPHERE), (SPHERE, CAPSULE), (SPHERE, BOX),
                       (CAPSULE, CAPSULE), (CAPSULE, BOX)})
_STATIC = frozenset((a, b) for a in _KIND for b in _KIND
                    if (a, b) != (BOX, BOX))
# (mode, group key) of every group the kernel takes
KEYS = frozenset({("pairs", k) for k in _DISCRETE}
                 | {("moving", k) for k in _DISCRETE}
                 | {("static", k) for k in _STATIC})
MAX_DIMS = 4          # batch dims the kernel indexes
_DTYPES = {torch.float32: 0, torch.float64: 1}
_LIBS = {}


# ------------------------------------------------------- the plain version


def pose_geom(Rl, pl, R_loc, p_loc, ea_loc, eb_loc):
    """World pose + capsule endpoints of geoms given their parent link
    poses (differentiable w.r.t. Rl/pl)."""
    R = Rl @ R_loc
    p = matvec(Rl, p_loc) + pl
    return R, p, matvec(R, ea_loc) + p, matvec(R, eb_loc) + p


def side_pose(side):
    """World pose of a group side given as (Rl, pl, local constants)."""
    return pose_geom(side[0], side[1], *side[2])


def scalar_kernel(key):
    """Discrete narrowphase kernel for a group key; pose_* = (R, p, ea, eb)
    world data, pr_* = padded params [..., 3]."""
    def kern(pose_a, pra, pose_b, prb):
        Ra, pa, eaa, eba = pose_a
        Rb, pb, eab, ebb = pose_b
        ra, rb = pra[..., 0], prb[..., 0]
        if key == (SPHERE, SPHERE):
            return geom.sphere_sphere(pa, ra, pb, rb)
        if key == (SPHERE, CAPSULE):
            return geom.sphere_capsule(pa, ra, eab, ebb, rb)
        if key == (SPHERE, BOX):
            return geom.sphere_box(pa, ra, Rb, pb, prb)
        if key == (CAPSULE, CAPSULE):
            return geom.capsule_capsule(eaa, eba, ra, eab, ebb, rb)
        if key == (CAPSULE, BOX):
            return geom.capsule_box(eaa, eba, ra, Rb, pb, prb)
        if key == (BOX, BOX):
            return geom.box_box_axis_aligned(Ra, pa, pra, Rb, pb, prb)
        if key == (BOX, "obb"):
            return geom.box_box(Ra, pa, pra, Rb, pb, prb)
        raise ValueError(f"unsupported group {key}")
    return kern


def swept_scalar_kernel(key):
    """Swept kernel: geom `a` sweeps pose_a0 -> pose_a1 against static `b`.
    Swept spheres are exact (capsules); capsules take the two swept edge
    segments plus the endpoint poses; box-box is the Minkowski-sum segment
    distance; boxes against spheres/capsules take the endpoint min."""
    ka, kb = key

    def kern(pose_a0, pose_a1, pra, pose_b, prb):
        Ra0, pa0, eaa0, eba0 = pose_a0
        Ra1, pa1, eaa1, eba1 = pose_a1
        Rb, pb, eab, ebb = pose_b
        ra, rb = pra[..., 0], prb[..., 0]
        if ka == SPHERE:
            if kb == SPHERE:
                return geom.sphere_capsule(pb, rb, pa0, pa1, ra)
            if kb == CAPSULE:
                return geom.capsule_capsule(pa0, pa1, ra, eab, ebb, rb)
            if kb == BOX:
                return geom.capsule_box(pa0, pa1, ra, Rb, pb, prb)
        if ka == CAPSULE:
            segs = ((eaa0, eaa1), (eba0, eba1), (eaa0, eba0), (eaa1, eba1))
            if kb == SPHERE:
                ds = [geom.sphere_capsule(pb, rb, s, e, ra) for s, e in segs]
            elif kb == CAPSULE:
                ds = [geom.capsule_capsule(s, e, ra, eab, ebb, rb)
                      for s, e in segs]
            else:
                ds = [geom.capsule_box(s, e, ra, Rb, pb, prb)
                      for s, e in segs]
            return torch.amin(torch.stack(ds, -1), -1)
        if ka == BOX and kb == BOX:
            ha_in_b = matvec(geom.abs_(Rb.transpose(-1, -2) @ Ra0), pra)
            return geom.segment_box(pa0, pa1, Rb, pb, prb + ha_in_b)
        if ka == BOX:  # kb in (SPHERE, CAPSULE): endpoint min, swapped
            disc = scalar_kernel((kb, ka))
            return torch.minimum(disc(pose_b, prb, pose_a0, pra),
                                 disc(pose_b, prb, pose_a1, pra))
        raise ValueError(f"unsupported swept group {key}")
    return kern


def grads(out, leaves):
    """Per-element gradients of ``out`` w.r.t. each leaf (zeros where a
    leaf does not reach the output)."""
    gs = torch.autograd.grad(out.sum(), leaves, allow_unused=True)
    return [torch.zeros_like(l) if g is None else g
            for g, l in zip(gs, leaves)]


def leaf(t):
    return t.detach().requires_grad_(True)


def compose_pose_grads(gR, gp, Rl, pl, mask, z, zxo, is_rev):
    """[..., Pg, n_dof] joint-space gradient of one side's link pose
    gradients: revolute dd/dq_j = z_j.(p_l x gp + sum_c R_c x gR_c)
    - (z_j x o_j).gp; prismatic z_j.gp; rows masked by ``mask [Pg,
    n_dof]`` (zero for static geoms)."""
    m = geom.cross(pl, gp) + geom.cross(
        Rl.transpose(-1, -2), gR.transpose(-1, -2)).sum(-2)
    zt = z[..., None, :, :]                       # [..., 1, n_dof, 3]
    term_rev = (m[..., None, :] * zt).sum(-1) \
        - (gp[..., None, :] * zxo[..., None, :, :]).sum(-1)
    term_pri = (gp[..., None, :] * zt).sum(-1)
    return mask * torch.where(is_rev, term_rev, term_pri)


def discrete_plain(key, ta, tb, sa, sb, axes=None):
    """One discrete group: distances [..., Pg] from each side's (Rl, pl,
    locals); with ``axes = (z, zxo, is_rev)`` also the Jacobian [..., Pg,
    n_dof]."""
    kern = scalar_kernel(key)
    if axes is None:
        return (kern(side_pose(sa), ta["params"], side_pose(sb),
                     tb["params"]),)
    with torch.enable_grad():
        leaves = [leaf(v) for v in (*sa[:2], *sb[:2])]
        d = kern(pose_geom(*leaves[:2], *sa[2]), ta["params"],
                 pose_geom(*leaves[2:], *sb[2]), tb["params"])
        g = grads(d, leaves)
    return d.detach(), (
        compose_pose_grads(g[0], g[1], *sa[:2], ta["mask"], *axes)
        + compose_pose_grads(g[2], g[3], *sb[:2], tb["mask"], *axes))


def moving_plain(key, ta, tb, sa0, sb0, sa1, sb1, axes0=None, axes1=None):
    """One swept group of two moving sides: the endpoint min of the
    discrete distances [..., Pg]; with the endpoints' ``axes`` also J0 and
    J1 [..., Pg, n_dof]."""
    kern = scalar_kernel(key)
    if axes0 is None:
        return (torch.minimum(
            kern(side_pose(sa0), ta["params"], side_pose(sb0), tb["params"]),
            kern(side_pose(sa1), ta["params"], side_pose(sb1),
                 tb["params"])),)
    with torch.enable_grad():
        leaves = [leaf(v) for v in (*sa0[:2], *sb0[:2], *sa1[:2], *sb1[:2])]
        d = torch.minimum(
            kern(pose_geom(*leaves[0:2], *sa0[2]), ta["params"],
                 pose_geom(*leaves[2:4], *sb0[2]), tb["params"]),
            kern(pose_geom(*leaves[4:6], *sa1[2]), ta["params"],
                 pose_geom(*leaves[6:8], *sb1[2]), tb["params"]))
        g = grads(d, leaves)
    return (d.detach(),
            compose_pose_grads(g[0], g[1], *sa0[:2], ta["mask"], *axes0)
            + compose_pose_grads(g[2], g[3], *sb0[:2], tb["mask"], *axes0),
            compose_pose_grads(g[4], g[5], *sa1[:2], ta["mask"], *axes1)
            + compose_pose_grads(g[6], g[7], *sb1[:2], tb["mask"], *axes1))


def static_plain(key, ta, tb, sa0, sa1, sb, axes0=None, axes1=None):
    """One swept group of a moving side a against static side b: the swept
    distances [..., Pg]; with the endpoints' ``axes`` also J0 and J1
    [..., Pg, n_dof]."""
    kern = swept_scalar_kernel(key)
    if axes0 is None:
        return (kern(side_pose(sa0), side_pose(sa1), ta["params"],
                     side_pose(sb), tb["params"]),)
    with torch.enable_grad():
        leaves = [leaf(v) for v in (*sa0[:2], *sa1[:2])]
        d = kern(pose_geom(*leaves[:2], *sa0[2]),
                 pose_geom(*leaves[2:], *sa1[2]), ta["params"],
                 side_pose(sb), tb["params"])
        g = grads(d, leaves)
    return (d.detach(),
            compose_pose_grads(g[0], g[1], *sa0[:2], ta["mask"], *axes0),
            compose_pose_grads(g[2], g[3], *sa1[:2], ta["mask"], *axes1))


# ------------------------------------------------------------------ plans


@dataclasses.dataclass
class Group:
    """One primitive group of a query: its mode, key, the pair indices
    ``idx`` (host and on the device), the scene's group arrays ``a``/``b``
    and their tensors ``ta``/``tb``."""
    mode: str
    key: tuple
    idx: np.ndarray
    idx_t: torch.Tensor
    a: dict
    b: dict
    ta: dict
    tb: dict


@dataclasses.dataclass
class Plan:
    """A query's primitive groups on one device and dtype, and the
    kernel's per-pair tables for those whose key is in :data:`KEYS`
    (concatenated in group order): ``ftab [Pk, 2, 18]`` each side's local
    rotation (9), capsule ends (3 + 3) and params (3); ``itab [Pk, 3]``
    int32 (link of side a, of side b, -1 for world geometry; output
    column); ``coef [Pk, n_dof]`` the sign and ancestry of each joint's
    column; ``ploc [Pk, 2, 3]`` each side's local center; ``rev [n_dof]``
    int32 (revolute joints); ``overrides`` lists (side, row, params key) of
    centers read from ``params``."""
    kind: str                 # "pairs" (discrete) or "swept"
    n_pairs: int
    n_dof: int
    groups: list              # every primitive Group
    kernel_groups: list       # (mode, key, Pg, first row) the kernel takes
    plain: list               # the Groups it does not take
    ftab: torch.Tensor | None = None
    itab: torch.Tensor | None = None
    coef: torch.Tensor | None = None
    ploc: torch.Tensor | None = None
    rev: torch.Tensor | None = None
    overrides: tuple = ()


def _coef(mode, key, tree, a, b) -> np.ndarray:
    """[Pg, n_dof] factor of each joint's column of the kernel's twist
    gradient: side a's ancestry less side b's (discrete and moving groups:
    the tangent rides side a, side b's twist gradient is its negative); a
    static group's moving side's ancestry, negated when the tangent rides
    side b (a box sweeping against a sphere or capsule)."""
    def mask(arrs):
        return (tree.ancestor[np.maximum(arrs["link"], 0)]
                * (~arrs["is_static"])[:, None]).astype(float)
    if mode != "static":
        return mask(a) - mask(b)
    return -mask(a) if key[0] == BOX else mask(a)


def make_plan(scene, kind: str, like: torch.Tensor) -> Plan:
    """The :class:`Plan` of ``scene``'s ``kind`` query on ``like``'s device
    and dtype (built on the host and uploaded once; the scene caches it
    beside its group tensors)."""
    tree = scene.tree
    dev, dt = like.device, like.dtype
    if kind == "pairs":
        listed = [("pairs", g) for g in scene._pair_groups()[0]]
        n_pairs = len(scene._pair_groups()[-1])
    else:
        moving, static, _, inv = scene._swept_groups()
        listed = [("moving", g) for g in moving] + \
            [("static", g) for g in static]
        n_pairs = len(inv)
    groups = []
    for mode, (key, idx, a, b) in listed:
        if "verts" in a:          # the convex group
            continue
        groups.append(Group(mode, key, idx,
                            torch.as_tensor(idx, dtype=torch.long,
                                            device=dev),
                            a, b, scene._tensors(a, like),
                            scene._tensors(b, like)))
    taken = [g for g in groups if (g.mode, g.key) in KEYS]
    plan = Plan(kind, n_pairs, tree.n_dof, groups, [],
                [g for g in groups if (g.mode, g.key) not in KEYS])
    if not taken:
        return plan
    ftab, itab, coef, ploc, over = [], [], [], [], []
    row = 0
    for g in taken:
        n = len(g.idx)
        plan.kernel_groups.append((g.mode, g.key, n, row))
        sides = []
        for s, arrs in enumerate((g.a, g.b)):
            sides.append(np.concatenate(
                [arrs["R"].reshape(n, 9), arrs["ea"], arrs["eb"],
                 arrs["params"]], 1))
            for r, k in enumerate(arrs["p_params"]):
                if k is not None:
                    over.append((s, row + r, k))
        ftab.append(np.stack(sides, 1))
        itab.append(np.stack([g.a["link"], g.b["link"], g.idx], 1))
        coef.append(_coef(g.mode, g.key, tree, g.a, g.b))
        ploc.append(np.stack([g.a["p"], g.b["p"]], 1))
        row += n
    kw = dict(dtype=dt, device=dev)
    plan.ftab = torch.as_tensor(np.concatenate(ftab), **kw)
    plan.itab = torch.as_tensor(np.concatenate(itab), dtype=torch.int32,
                                device=dev)
    plan.coef = torch.as_tensor(np.concatenate(coef), **kw)
    plan.ploc = torch.as_tensor(np.concatenate(ploc), **kw)
    plan.rev = torch.as_tensor(tree._active_types() == 0, dtype=torch.int32,
                               device=dev)
    plan.overrides = tuple(over)
    return plan


def lead(v: torch.Tensor, n_batch: int) -> torch.Tensor:
    """``[*lead, 3]`` -> ``[*lead, 1, ..., 1, 3]`` with ``n_batch`` batch
    axes, the given ones leading."""
    return v.reshape(*v.shape[:-1], *(1,) * (n_batch - v.dim() + 1), 3)


# -------------------------------------------------------- the plain route


def query_plain(scene, plan: Plan, fks, params, outs, groups=None):
    """The plain version of ``plan``'s groups (default all) on any device:
    ``outs`` with each group's results copied into its columns -- ``(d,)``,
    ``(d, J)`` (discrete) or ``(d, J0, J1)`` (swept) -- from the endpoint
    poses ``fks`` (``(R, p)`` or ``(R, p, z, o)`` each)."""
    jac = len(outs) > 1
    fk0 = fks[0]
    fk1 = fks[1] if len(fks) > 1 else None
    axes0 = axes1 = None
    if jac:
        is_rev = scene.tree.revolute(fk0[0].device)
        axes0 = (fk0[2], geom.cross(fk0[2], fk0[3]), is_rev)
        if fk1 is not None:
            axes1 = (fk1[2], geom.cross(fk1[2], fk1[3]), is_rev)
    for g in plan.groups if groups is None else groups:
        def side(t, fk):
            return scene._side(t, fk[0], fk[1], params)
        if g.mode == "pairs":
            res = discrete_plain(g.key, g.ta, g.tb, side(g.ta, fk0),
                                 side(g.tb, fk0), axes0)
        elif g.mode == "moving":
            res = moving_plain(g.key, g.ta, g.tb, side(g.ta, fk0),
                               side(g.tb, fk0), side(g.ta, fk1),
                               side(g.tb, fk1), axes0, axes1)
        else:
            res = static_plain(g.key, g.ta, g.tb, side(g.ta, fk0),
                               side(g.ta, fk1), side(g.tb, fk0), axes0,
                               axes1)
        outs = put(outs, g.idx_t, res)
    return outs


def put(outs, idx, parts):
    """``outs`` (d [..., P] and Jacobians [..., P, n_dof]) with one
    group's results copied into its columns ``idx``: in place on the card
    (where :func:`query` refuses ``torch.func`` transforms), out of place
    elsewhere, so that such transforms of a query on the CPU batch it."""
    if outs[0].is_cuda:
        outs[0].index_copy_(-1, idx, parts[0])
        for o, p in zip(outs[1:], parts[1:]):
            o.index_copy_(-2, idx, p)
        return outs
    return (torch.index_copy(outs[0], -1, idx, parts[0]),
            *(torch.index_copy(o, -2, idx, p)
              for o, p in zip(outs[1:], parts[1:])))


# ------------------------------------------------------- the kernel route


def build(verbose: bool = False):
    """Compile the kernel (once per source hash) and return the library
    path; see ``kernels.build_library``."""
    return kernels.build_library(SOURCE, verbose, flags=FLAGS)


def build_host(verbose: bool = False):
    """Compile the host build of the kernel's device functions (tests)."""
    return kernels.build_library(HOST_SOURCE, verbose, compiler="g++",
                                 flags=HOST_FLAGS)


def _lib(host: bool):
    if host not in _LIBS:
        lib = ctypes.CDLL(str(build_host() if host else build()))
        fn = lib.primitive_host if host else lib.primitive_narrowphase
        longs = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, longs, ctypes.c_int,
                       longs, ctypes.POINTER(ctypes.c_void_p)] + (
                           [] if host else [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIBS[host] = fn
    return _LIBS[host]


def _plocs(plan: Plan, batch, params):
    """Each side's local centers [*batch, Pk, 3]: the plan's (stride 0 over
    the batch), or a copy with the ``center_param`` rows read from
    ``params``."""
    base = plan.ploc.expand(*batch, *plan.ploc.shape)
    if params is not None and plan.overrides:
        base = base.clone()
        for s, r, k in plan.overrides:
            base[..., r, s, :] = lead(torch.as_tensor(
                params[k], dtype=base.dtype, device=base.device),
                len(batch))
    return base[..., 0, :], base[..., 1, :]


def _launch(plan: Plan, fks, params, outs, host: bool) -> None:
    """Check the operands and launch the kernel on ``plan``'s kernel
    groups, one launch a group (``host``: run its host build)."""
    swept = plan.kind == "swept"
    jac = len(outs) > 1
    fk0 = fks[0]
    fk1 = fks[1] if swept else fk0
    R0 = fk0[0]
    batch = R0.shape[:-3]
    dev, dt = R0.device, R0.dtype
    if dt not in _DTYPES:
        raise TypeError(f"link poses: expected float32 or float64, got {dt}")
    want = "cpu" if host else "cuda"
    n_fk = 4 if jac else 2
    if len(fks) != (2 if swept else 1) or any(len(f) < n_fk for f in fks):
        raise ValueError(f"expected {2 if swept else 1} endpoint(s) of "
                         f"{n_fk} tensors")
    L, n_dof = R0.shape[-3], plan.n_dof
    shapes = ((*batch, L, 3, 3), (*batch, L, 3), (*batch, n_dof, 3),
              (*batch, n_dof, 3))
    for f in (fk0, fk1):
        for t, shape in zip(f[:n_fk], shapes):
            if t.device != dev or dev.type != want:
                raise ValueError(f"expected {want} tensors on one device, "
                                 f"got {t.device}")
            if t.dtype != dt:
                raise TypeError(f"expected {dt}, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"expected shape {shape}, got "
                                 f"{tuple(t.shape)}")
    out_shapes = ((*batch, plan.n_pairs),) + ((*batch, plan.n_pairs,
                                                n_dof),) * (len(outs) - 1)
    for t, shape in zip(outs, out_shapes):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"outputs: expected contiguous {dt} {shape} "
                             f"on {dev}")
    if plan.ftab.device != dev or plan.ftab.dtype != dt:
        raise ValueError("the plan is for another device or dtype")
    pla, plb = _plocs(plan, batch, params)
    ins = [fk0[0], fk0[1], fk1[0], fk1[1]]
    ins += [fk0[2], fk0[3], fk1[2], fk1[3]] if jac else [fk0[0]] * 4
    ins += [pla, plb]
    sizes, strides = _batch_layout(batch, ins)
    nd = len(sizes)
    pad = MAX_DIMS - nd
    n_batch = int(np.prod(batch, dtype=np.int64))
    lay = [n_batch, nd, *sizes, *[1] * pad]
    for st in strides:
        lay += [*st, *[0] * pad]
    for f in (fk0, fk1):
        R, p = f[0], f[1]
        z, o = (f[2], f[3]) if jac else (R, R)
        lay += [R.stride(-3), R.stride(-2), R.stride(-1), p.stride(-2),
                p.stride(-1), z.stride(-2), z.stride(-1), o.stride(-2),
                o.stride(-1)]
    lay += [pla.stride(-2), plb.stride(-2), pla.stride(-1), plb.stride(-1)]
    lay += [plan.n_pairs, n_dof]
    groups = [(MODES.index(mode) * 16 + _KIND[ka] * 4 + _KIND[kb], n, row)
              for mode, (ka, kb), n, row in plan.kernel_groups
              if n_batch * n]
    if not groups:
        return
    ptrs = [t.data_ptr() for t in ins]
    ptrs += [t.data_ptr() for t in (plan.ftab, plan.itab, plan.coef,
                                    plan.rev)]
    ptrs += [outs[0].data_ptr()] + [
        outs[k].data_ptr() if k < len(outs) else None for k in (1, 2)]
    flat = [v for g in groups for v in g]
    args = [_DTYPES[dt], int(jac), (ctypes.c_longlong * len(lay))(*lay),
            len(groups), (ctypes.c_longlong * len(flat))(*flat),
            (ctypes.c_void_p * len(ptrs))(*ptrs)]
    if host:
        err = _lib(True)(*args)
    else:
        err = _lib(False)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"primitive_narrowphase "
                           f"{'host run' if host else 'launch'} failed: "
                           f"error {err}")
    if not host:
        profiling.count("collision.primitive.launches")
        profiling.count("collision.primitive.kernels", len(groups))
        profiling.count("collision.primitive.queries",
                        n_batch * sum(n for _, n, _ in groups))


# Floating-point operations of the kernel's functions on plain values (a
# multiply, add, division or square root counted as 1, a fused
# multiply-add as 2; comparisons and selects not counted), from
# csrc/primitive_narrowphase.cuh: the discrete kernels, and segment_box's
# share that runs without tangents (the 17-sample scan and the golden
# steps, 597 of its 835).
_GEOM = {(SPHERE, SPHERE): 11, (SPHERE, CAPSULE): 35, (SPHERE, BOX): 29,
         (CAPSULE, CAPSULE): 76, (CAPSULE, BOX): 836}
_SEARCH = 597
_POSE = 99           # a link geom's world rotation, center and capsule ends


def primitive_flops(mode: str, key, jac: bool, n_dof: int) -> int:
    """Floating-point operations of one query of a ``mode`` group of
    ``key`` as the kernel computes it: the world poses, the geometry (a
    tangent-carrying operation on N slots counted as 1 + 2N; segment_box's
    search on plain values), and with ``jac`` each endpoint's twist
    gradient (21 a point) and joint columns (22 a joint).  A swept segment
    (a sphere's one, each of a capsule's four) carries the 6 slots of its
    two points."""
    ka, kb = key
    npts = {SPHERE: 1, CAPSULE: 2}
    if mode == "static":
        if ka == BOX:
            calls, pk, n = [(kb, BOX)] * 2, kb, 3 * npts[kb]
        else:
            segs = 1 if ka == SPHERE else 4
            cap = {SPHERE: (SPHERE, CAPSULE), CAPSULE: (CAPSULE, CAPSULE),
                   BOX: (CAPSULE, BOX)}[kb]
            calls, pk, n = [cap] * segs, ka, 6
        poses, ends = 3, 2
    else:
        calls = [key] * (2 if mode == "moving" else 1)
        pk, n = ka, 3 * npts[ka]
        poses, ends = 4 if mode == "moving" else 2, len(calls)
    flops = poses * _POSE
    for c in calls:
        plain = _SEARCH if c == (CAPSULE, BOX) else 0
        flops += plain + (_GEOM[c] - plain) * ((1 + 2 * n) if jac else 1)
    if jac:
        flops += ends * (21 * npts[pk] + 22 * n_dof)
    return flops


def primitive_bytes(plan: Plan, fks, outs, params=None) -> int:
    """Bytes the kernel must move for one query: each input element read
    once (the FK outputs it reads, a broadcast dim's repeats not counted;
    the pair tables) and each output element written once."""
    def unique(t):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        return n * t.element_size()

    jac = len(outs) > 1
    ins = [t for f in fks for t in f[:4 if jac else 2]]
    ins += [plan.ftab, plan.itab, plan.coef, plan.rev,
            *_plocs(plan, fks[0][0].shape[:-3], params)]
    return sum(unique(t) for t in ins) + sum(unique(t) for t in outs)


def query_cuda(plan: Plan, fks, params, outs) -> None:
    """Launch the kernel on the current stream for ``plan``'s kernel
    groups (one launch a group, back to back), writing their columns of
    ``outs`` (contiguous; see :func:`query_plain`) from CUDA tensors of any
    strides."""
    _launch(plan, fks, params, outs, host=False)


def query_host(plan: Plan, fks, params, outs) -> None:
    """The kernel's device functions compiled for the host, on CPU
    tensors (as :func:`query_cuda`; for the CPU tests)."""
    _launch(plan, fks, params, outs, host=True)


def plan_of(scene, kind: str, like: torch.Tensor) -> Plan:
    """``scene``'s cached :class:`Plan` of a ``kind`` query on ``like``'s
    device and dtype."""
    if getattr(scene, "_tensor_cache", None) is None:
        scene._tensor_cache = {}
    key = ("primitive", kind, like.device, like.dtype)
    if key not in scene._tensor_cache:
        scene._tensor_cache[key] = make_plan(scene, kind, like)
    return scene._tensor_cache[key]


def _refuse_transforms(fks, params, outs) -> None:
    """The kernel writes values and Jacobians, not an autograd graph:
    refuse CUDA operands that a ``torch.func`` transform wraps or that
    require grad (the solver's terms take the queries' Jacobians; on the
    CPU the plain version differentiates)."""
    ts = [t for f in fks for t in f] + list(outs)
    if params:
        ts += [v for v in params.values() if isinstance(v, torch.Tensor)]
    for t in ts:
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise ValueError("the primitive narrowphase on CUDA takes no "
                             "torch.func transform (vmap, jacrev, grad): "
                             "use the query's Jacobians")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("the primitive narrowphase on CUDA does not "
                             "differentiate its inputs: use the query's "
                             "Jacobians")


def query(scene, kind: str, fks, params, outs):
    """``outs`` with the primitive groups of ``scene``'s ``kind`` query
    (``"pairs"`` or ``"swept"``) filled in (see :func:`query_plain`), inside
    the span ``collision.primitive`` when the query has such groups.  A
    call that launches the kernel counts ``collision.primitive.launches``
    (one), ``.kernels`` (one a group) and ``.queries`` (the groups' queries,
    pad lanes included); under a captured region each replay counts them
    again (``utils/profiling.py``).  CPU tensors take the plain version;
    CUDA tensors launch the kernel for the groups in :data:`KEYS`, in
    place, and run the plain version for the rest (a ``torch.func``
    transform or an input that requires grad raises); meta tensors return
    the outputs as they are (their shapes); any other device raises."""
    dev = outs[0].device
    if dev.type == "meta":
        return outs
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no primitive narrowphase for device {dev}")
    if dev.type == "cuda":
        _refuse_transforms(fks, params, outs)
    plan = plan_of(scene, kind, fks[0][0])
    if not plan.groups:
        return outs
    with profiling.span(RANGE):
        if dev.type == "cpu":
            return query_plain(scene, plan, fks, params, outs)
        if plan.kernel_groups:
            query_cuda(plan, fks, params, outs)
        if plan.plain:
            outs = query_plain(scene, plan, fks, params, outs, plan.plain)
        return outs
