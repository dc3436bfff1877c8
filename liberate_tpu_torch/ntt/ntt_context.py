"""NTT context: per-level modular constants as int64 tensors on the device.

The master tables cover every prime of the context once; a ``LevelPack``
is a contiguous channel slice of them (views, no copies), built lazily per
(level, mult_type), and a ``PartPlan`` holds one gadget part's tables for
the hybrid key switch.

A context serves one NTT domain throughout: the butterfly kernels'
bit-reversed domain (a pack's ``plan``, with Shoup-form twiddles or, with
``shoup_twiddles`` off, Montgomery-form ones), or, with ``use_mxu``, the
tensor-core kernels' natural-order domain (a pack's ``mxu``: the width
groups that meet its channel range, each with the group tables cut to its
channels; with ``mxu_pallas`` off the one plan over every channel with the
Montgomery recombination instead, ``mxu_ntt.master_plans``).

Channel layout: the global prime order is q = [scales..., base,
specials...]. At level l the alive channels are the contiguous suffix
q[l:]; mult_type -1 excludes the trailing special primes, -2 includes them.
On a mesh (``mesh``) a layout's channel axis is padded to a multiple of
the ``rns`` axis size by repeating its last channel, and a rank's packs
hold its rows of it (``rows``; ``liberate_tpu_torch.parallel``): in the
tensor-core domain each width group its rows cut from the group's tables
(copies where the padding repeats a channel). On a mesh with a ``coef``
axis (butterfly domain only) a rank's level packs carry the
``CoefShardPlan`` of its rows (``coef``) instead of a whole-length plan,
and the ``ops`` transforms run the coefficient-sharded ones.
"""

from typing import NamedTuple, Optional

import torch

from . import mxu_ntt, u64
from .cuda_mxu import MxuGroup
from ..parallel.coef_shard import make_coef_plan
from ..parallel.sharding import shard_rows
from .cuda_ntt import NttPlan, make_plan
from .rns_partition import RnsPartition


class LevelPack(NamedTuple):
    """Per-channel constants of one channel layout, each an int64 [C]
    tensor. ql/qh/kl/kh are the 31-bit half limbs of q and
    k = -q^-1 mod R; Rs = R^2 mod q, Rs_scale = R^2 * 2^scale_bits
    mod q and Rm = R mod q (the Montgomery identity)."""
    q: torch.Tensor
    q2: torch.Tensor
    ql: torch.Tensor
    qh: torch.Tensor
    kl: torch.Tensor
    kh: torch.Tensor
    Rs: torch.Tensor
    Rs_scale: torch.Tensor
    Rm: torch.Tensor
    plan: Optional[NttPlan] = None   # butterfly kernel tables
    mxu: Optional[tuple] = None      # MxuGroups of the tensor-core kernels
    coef: Optional[object] = None    # CoefShardPlan on a coef mesh

    def mont(self):
        """(ql, qh, kl, kh) as [C, 1] columns for montmul on [..., C, N]."""
        return tuple(t[:, None] for t in (self.ql, self.qh, self.kl, self.kh))


class PartPlan(NamedTuple):
    """Tables of one gadget part of the hybrid key switch.

    Y_scalar[i] applies on channel prime_idx[i+1]; L_scalar[i] on channels
    prime_idx[i+2:] (both Montgomery form). Per divided-difference term,
    over the full level-0 with-special layout: L_enter, L_i R^2 mod q (the
    Montgomery extension's scalars), and L_enter_sh, (w, wp, cadj) of the
    Shoup extension: w = L_i mod q (plain), wp = floor(w * 2^64 / q),
    cadj = 2q - (2^63 * w mod q), the correction for operands offset by
    2^63.
    """
    part_id: int
    prime_idx: tuple
    local_start: int
    alpha: int
    pack: LevelPack
    Y_scalar: Optional[torch.Tensor]
    L_scalar: tuple
    L_enter: tuple
    L_enter_sh: tuple


class NttContext:
    """On a mesh (``liberate_tpu_torch.parallel.Mesh``) the context holds
    one rank's rows of the ``rns`` axis and, on a mesh with a ``coef`` axis,
    its columns; the ranks of one process share the tensor-core tables
    (``Mesh.shared``)."""

    def __init__(self, ctx, device, use_mxu=False, mesh=None,
                 shoup_twiddles=True, mxu_pallas=True):
        self.coef_sharded = mesh is not None and mesh.axis_size("coef") > 1
        if use_mxu and self.coef_sharded:
            raise ValueError(
                "the tensor-core domain runs on an rns mesh only: a mesh "
                "with a coef axis shards the butterfly transforms "
                "(use_mxu_ntt=False, or make_mesh(n))")
        self.ctx = ctx
        self.device = torch.device(device)
        self.use_mxu = use_mxu
        self.shoup_twiddles = shoup_twiddles
        self.mesh = mesh
        # (this rank's index, the size) of the rns axis.
        self.shard = None if mesh is None else (mesh.axis_index("rns"),
                                                mesh.axis_size("rns"))
        self.num_ordinary_primes = ctx.num_scales + 1
        self.num_special_primes = ctx.num_special_primes
        self.num_levels = ctx.num_scales + 1
        self.total_channels = len(ctx.q)
        self.logN = ctx.logN
        self.p = RnsPartition(self.num_ordinary_primes,
                              self.num_special_primes, 1)
        self._build_master_tables()
        # Width-group plans ((start, stop, MxuPlan), ...) over global
        # channels, in the tensor-core domain only (the one master plan
        # without mxu_pallas).
        self.mxu_groups = None
        if use_mxu:
            plans = mxu_ntt.group_plans if mxu_pallas else mxu_ntt.master_plans

            def build():
                return plans(ctx, self.device)
            self.mxu_groups = (build() if mesh is None else mesh.shared(
                ("mxu_groups", mxu_pallas, id(ctx), str(self.device)),
                build))
        self._level_packs = {}
        self._part_plans = {}

    def _tensor(self, vals):
        return u64.tensor(vals, self.device)

    def _build_master_tables(self):
        ctx = self.ctx
        self.q_list = list(ctx.q)
        scale = 2 ** ctx.scale_bits
        self._master = LevelPack(
            q=self._tensor(ctx.q),
            q2=self._tensor(ctx.q_double),
            ql=self._tensor(ctx.q_lower_bits),
            qh=self._tensor(ctx.q_higher_bits),
            kl=self._tensor(ctx.k_lower_bits),
            kh=self._tensor(ctx.k_higher_bits),
            Rs=self._tensor(ctx.R_square),
            Rs_scale=self._tensor([(Rs * scale) % q
                                   for Rs, q in zip(ctx.R_square, ctx.q)]),
            Rm=self._tensor([ctx.R % q for q in ctx.q]),
            plan=None if self.use_mxu else make_plan(
                ctx.logN, ctx.q, ctx.k, ctx.psi, ctx.psi_inv, self.device,
                mont=not self.shoup_twiddles),
        )

    # -- channel ranges ----------------------------------------------------------

    def channel_range(self, level: int, mult_type: int):
        """(start, stop) slice of the global prime order for this layout."""
        stop = (self.total_channels if mult_type == -2
                else self.num_ordinary_primes)
        return level, stop

    def num_channels(self, level: int, mult_type: int) -> int:
        start, stop = self.channel_range(level, mult_type)
        return stop - start

    def q_ints(self, level: int, mult_type: int):
        start, stop = self.channel_range(level, mult_type)
        return self.q_list[start:stop]

    def rows(self, level: int, mult_type: int):
        """The global channels this rank holds of a layout, in order: all of
        them on one device; on a mesh its rows of the padded layout (the
        padding repeats the last channel)."""
        start, stop = self.channel_range(level, mult_type)
        if self.shard is None:
            return list(range(start, stop))
        return [start + j for j in shard_rows(*self.shard, stop - start)]

    def q_rows(self, level: int, mult_type: int):
        """The moduli of ``rows``."""
        return [self.q_list[r] for r in self.rows(level, mult_type)]

    # -- packs ----------------------------------------------------------------------

    def make_pack(self, start: int, stop: int, with_plan=True) -> LevelPack:
        """The pack of channels [start, stop) of the global order, with the
        transform tables of the context's domain when ``with_plan``."""
        m = self._master
        plan = mxu = None
        if with_plan and self.use_mxu:
            mxu = self._mxu_groups(list(range(start, stop)))
        elif with_plan:
            plan = m.plan.slice(start, stop)
        return LevelPack(*(t[start:stop] for t in m[:-3]), plan=plan,
                         mxu=mxu)

    def _mxu_groups(self, rows):
        """The width groups of the ascending global channels ``rows``: for
        each group they meet, its run of them, with the group's tables cut
        to that run (views where the run is contiguous; copies where the
        padding repeats a channel)."""
        out = []
        for gs, ge, p in self.mxu_groups:
            pos = [i for i, r in enumerate(rows) if gs <= r < ge]
            if not pos:
                continue
            sel = [rows[i] - gs for i in pos]
            if sel == list(range(sel[0], sel[-1] + 1)):
                cut = p.slice(sel[0], sel[-1] + 1)
            else:
                cut = p.select(torch.tensor(sel, device=self.device))
            out.append(MxuGroup(pos[0], pos[-1] + 1, cut))
        return tuple(out)

    def make_pack_rows(self, rows, with_plan=True) -> LevelPack:
        """The pack of the global channels ``rows``: views where they are
        contiguous, else copies."""
        if rows == list(range(rows[0], rows[-1] + 1)):
            return self.make_pack(rows[0], rows[-1] + 1, with_plan)
        sel = torch.tensor(rows, device=self.device)
        m = self._master
        plan = mxu = None
        if with_plan and self.use_mxu:
            mxu = self._mxu_groups(rows)
        elif with_plan:
            plan = m.plan.select(sel)
        return LevelPack(*(t.index_select(0, sel) for t in m[:-3]),
                         plan=plan, mxu=mxu)

    def level_pack(self, level: int = 0, mult_type: int = -1) -> LevelPack:
        """The pack of a layout: this rank's rows of it on a mesh, with
        their ``CoefShardPlan`` on a coef mesh."""
        key = (level, mult_type)
        if key not in self._level_packs:
            rows = self.rows(level, mult_type)
            if not self.coef_sharded:
                pack = self.make_pack_rows(rows)
            else:
                pack = self.make_pack_rows(rows, with_plan=False)._replace(
                    coef=make_coef_plan(self, self.mesh, idx=rows))
            self._level_packs[key] = pack
        return self._level_packs[key]

    # -- key-switching part plans -----------------------------------------------

    def parts(self, level: int):
        """Gadget parts at this level (ordinary primes only)."""
        if level not in self._part_plans:
            self._part_plans[level] = self._build_parts(level)
        return self._part_plans[level]

    def _build_parts(self, level: int):
        ctx = self.ctx
        R = ctx.R
        plans = []
        # Parts partition the alive ordinary primes [level, num_ordinary).
        # Global partition j covers primes [j*alpha, (j+1)*alpha) plus the
        # base-prime partition; at a level the lowest partition may be
        # partial. part_id is the GLOBAL partition index, which addresses
        # the key component generated for the same partition at level 0.
        alpha0 = self.num_special_primes
        nscale = self.num_ordinary_primes - 1
        num_partitions = -(-nscale // alpha0)
        bounds = [0] + [min((j + 1) * alpha0, nscale)
                        for j in range(num_partitions)] + [nscale + 1]
        local = 0
        for j in range(len(bounds) - 1):
            lo, hi = max(bounds[j], level), bounds[j + 1]
            if hi <= lo:
                continue
            prime_idx = tuple(range(lo, hi))
            alpha = len(prime_idx)
            m = [ctx.q[i] for i in prime_idx]

            # Divided-difference tables.
            L = [m[0]]
            for i in range(1, alpha - 1):
                L.append(L[-1] * m[i])
            Y_scalar, L_scalar, L_enter, L_enter_sh = None, (), (), ()
            if alpha > 1:
                Y_scalar = self._tensor(
                    [(pow(L[i], -1, m[i + 1]) * R) % m[i + 1]
                     for i in range(alpha - 1)])
                L_scalar = tuple(
                    self._tensor([(L[i] * R) % m[jj]
                                  for jj in range(i + 2, alpha)])
                    for i in range(alpha - 2))
                L_enter = tuple(
                    self._tensor([L[i] * Rs % q
                                  for q, Rs in zip(ctx.q, ctx.R_square)])
                    for i in range(alpha - 1))
                le_sh = []
                for i in range(alpha - 1):
                    ws = [L[i] % q for q in ctx.q]
                    le_sh.append((
                        self._tensor(ws),
                        self._tensor([(w << 64) // q
                                      for w, q in zip(ws, ctx.q)]),
                        self._tensor([2 * q - ((w << 63) % q)
                                      for w, q in zip(ws, ctx.q)])))
                L_enter_sh = tuple(le_sh)

            plans.append(PartPlan(
                part_id=j,
                prime_idx=prime_idx,
                local_start=local,
                alpha=alpha,
                pack=self.make_pack(lo, hi, with_plan=False),
                Y_scalar=Y_scalar,
                L_scalar=L_scalar,
                L_enter=L_enter,
                L_enter_sh=L_enter_sh,
            ))
            local += alpha
        return plans
