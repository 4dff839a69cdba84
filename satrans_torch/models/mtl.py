"""The multi-task models as multi-domain learners (twin of
``satrans_tpu/models/mtl.py``): SharedBottom, MMOE, PLE, ESMM.

The reference builds them with one "task" per scenario
(``task_types=['binary'] * num_domains``, main.py:262-265); its MTL engine
masks each head's loss to its domain's examples and routes each example
to its domain's head at predict (mtl_basemodel.py:262-271, 376-378).
Here that engine is ``train.trainer.DomainRouted`` (and the routing of
``serving.Predictor``); a model's ``forward`` returns ``[B, num_tasks]``
predictions.

No linear model (``linear_feature_columns=[]`` upstream).  SharedBottom,
MMOE and PLE take the ``usetrans`` stack (``models/common.DomainBase``);
ESMM builds it but does not run it, as the reference does not wire it
there.  In training each MLP draws its dropout from its own key: the
SharedBottom bottom from ``key``, tower ``i`` from ``fold_in(key, i)``;
MMOE's expert ``i`` from ``10 + i``, gate ``i`` from ``20 + i``, tower
``i`` from ``30 + i``; PLE's as ``_cgc`` names them; ESMM's CTR tower from
``key``, its CVR tower from ``fold_in(key, 1)``.

PLE's quirk is kept: the count of shared-expert modules comes from
``specific_expert_num`` (ple.py:272) while the forward runs
``shared_expert_num`` of them (ple.py:345), the same at the defaults.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..features import FeatureLayout
from ..nn import core
from ..ops import threefry
from .common import DomainBase


class _MTLBase(DomainBase):
    def __init__(self, layout: FeatureLayout, *, num_tasks: int = 2, **kw):
        if num_tasks <= 1:
            raise ValueError("num_tasks must be greater than 1")
        super().__init__(layout, **kw)
        self.num_tasks = num_tasks

    def _mlps(self, gen: torch.Generator, n: int, in_dim: int,
              units: Sequence[int]) -> nn.ModuleList | None:
        """``n`` MLPs from ``in_dim`` (None where ``units`` is empty)."""
        return nn.ModuleList(self._mlp(gen, in_dim, units)
                             for _ in range(n)) if units else None

    def _heads(self, gen: torch.Generator, n: int, in_dim: int,
               out_dim: int = 1) -> nn.ModuleList:
        """``n`` bias-free linear layers."""
        return nn.ModuleList(core.Linear(gen, in_dim, out_dim, use_bias=False)
                             for _ in range(n))

    def _run(self, mlp: core.MLP, x: torch.Tensor, train: bool, key):
        return mlp(x, dropout_rate=self.dnn_dropout, train=train, key=key)

    def _predictions(self, logits) -> torch.Tensor:
        return torch.cat([core.prediction(lg, self.task) for lg in logits],
                         dim=-1)


# ---------------------------------------------------------------------------
# SharedBottom (reference sharedbottom.py)
# ---------------------------------------------------------------------------

class SharedBottom(_MTLBase):
    def __init__(self, layout, *,
                 bottom_dnn_hidden_units: Sequence[int] = (256, 128),
                 tower_dnn_hidden_units: Sequence[int] = (64,), **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        T, towers = self.num_tasks, tower_dnn_hidden_units
        bottom = bottom_dnn_hidden_units[-1]
        self.bottom = self._mlp(gen, self.input_dim, bottom_dnn_hidden_units)
        self.towers = self._mlps(gen, T, bottom, towers)
        self.outs = self._heads(gen, T, towers[-1] if towers else bottom)

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        h = self._dnn_input(batch, feed, train=train, key=key)
        bottom = self._run(self.bottom, h, train, key)
        logits = []
        for i in range(self.num_tasks):
            t = bottom
            if self.towers is not None:
                t = self._run(self.towers[i], t, train,
                              threefry.fold_in(key, i))
            logits.append(self.outs[i](t))
        return self._predictions(logits)


# ---------------------------------------------------------------------------
# MMOE (reference mmoe.py)
# ---------------------------------------------------------------------------

class MMOE(_MTLBase):
    def __init__(self, layout, *, num_experts: int = 3,
                 expert_dnn_hidden_units: Sequence[int] = (256, 128),
                 gate_dnn_hidden_units: Sequence[int] = (64,),
                 tower_dnn_hidden_units: Sequence[int] = (64,), **kw):
        # before the bank is drawn; a bad task count raises first
        if num_experts <= 1 and kw.get("num_tasks", 2) > 1:
            raise ValueError("num_experts must be greater than 1")
        super().__init__(layout, **kw)
        gen = self._take_generator()
        T, gates, towers = (self.num_tasks, gate_dnn_hidden_units,
                            tower_dnn_hidden_units)
        expert_out = expert_dnn_hidden_units[-1]
        self.experts = self._mlps(gen, num_experts, self.input_dim,
                                  expert_dnn_hidden_units)
        self.gates = self._mlps(gen, T, self.input_dim, gates)
        self.gate_outs = self._heads(
            gen, T, gates[-1] if gates else self.input_dim, num_experts)
        self.towers = self._mlps(gen, T, expert_out, towers)
        self.tower_outs = self._heads(gen, T,
                                      towers[-1] if towers else expert_out)

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        h = self._dnn_input(batch, feed, train=train, key=key)
        experts = torch.stack(
            [self._run(e, h, train, threefry.fold_in(key, 10 + i))
             for i, e in enumerate(self.experts)], dim=1)     # [B, E, dim]
        logits = []
        for i in range(self.num_tasks):
            g = h
            if self.gates is not None:
                g = self._run(self.gates[i], g, train,
                              threefry.fold_in(key, 20 + i))
            gate = torch.softmax(self.gate_outs[i](g), dim=1)  # [B, E]
            t = torch.einsum("be,bed->bd", gate, experts)
            if self.towers is not None:
                t = self._run(self.towers[i], t, train,
                              threefry.fold_in(key, 30 + i))
            logits.append(self.tower_outs[i](t))
        return self._predictions(logits)


# ---------------------------------------------------------------------------
# PLE (reference ple.py)
# ---------------------------------------------------------------------------

class PLE(_MTLBase):
    def __init__(self, layout, *, shared_expert_num: int = 1,
                 specific_expert_num: int = 1, num_levels: int = 2,
                 expert_dnn_hidden_units: Sequence[int] = (256, 128),
                 gate_dnn_hidden_units: Sequence[int] = (64,),
                 tower_dnn_hidden_units: Sequence[int] = (64,), **kw):
        super().__init__(layout, **kw)
        gen = self._take_generator()
        T, S = self.num_tasks, specific_expert_num
        gates, towers = gate_dnn_hidden_units, tower_dnn_hidden_units
        self.shared_expert_num = shared_expert_num
        self.specific_expert_num = S
        self.num_levels = num_levels
        expert_out = expert_dnn_hidden_units[-1]
        levels = range(num_levels)

        def level_in(lv):
            return self.input_dim if lv == 0 else expert_out

        def gate_in(lv):
            return gates[-1] if gates else level_in(lv)

        self.specific_experts = nn.ModuleList(
            nn.ModuleList(self._mlps(gen, S, level_in(lv),
                                     expert_dnn_hidden_units)
                          for _ in range(T)) for lv in levels)
        # the quirk: the module count from specific_expert_num (ple.py:272)
        self.shared_experts = nn.ModuleList(
            self._mlps(gen, S, level_in(lv), expert_dnn_hidden_units)
            for lv in levels)
        self.specific_gates = self.shared_gates = None
        if gates:
            self.specific_gates = nn.ModuleList(
                self._mlps(gen, T, level_in(lv), gates) for lv in levels)
            self.shared_gates = nn.ModuleList(
                self._mlp(gen, level_in(lv), gates) for lv in levels)
        self.specific_gate_outs = nn.ModuleList(
            self._heads(gen, T, gate_in(lv), S + shared_expert_num)
            for lv in levels)
        self.shared_gate_outs = nn.ModuleList(
            core.Linear(gen, gate_in(lv), T * S + shared_expert_num,
                        use_bias=False) for lv in levels)
        self.towers = self._mlps(gen, T, expert_out, towers)
        self.tower_outs = self._heads(gen, T,
                                      towers[-1] if towers else expert_out)

    def _cgc(self, inputs, level, train, key):
        """One CGC layer (reference ple.py:332-379): each MLP's key is
        ``fold_in(key, salt)``, the salts of the JAX package's ``_cgc``."""
        def run(mlp, x, salt):
            return self._run(mlp, x, train, threefry.fold_in(key, salt))

        T, S = self.num_tasks, self.specific_expert_num
        specific = [run(self.specific_experts[level][i][j], inputs[i],
                        level * 100 + i * 10 + j)
                    for i in range(T) for j in range(S)]      # task-major
        shared = [run(self.shared_experts[level][k], inputs[-1],
                      level * 100 + 90 + k)
                  for k in range(self.shared_expert_num)]
        outs = []
        for i in range(T):
            cur = torch.stack(specific[i * S:(i + 1) * S] + shared, dim=1)
            g = inputs[i]
            if self.specific_gates is not None:
                g = run(self.specific_gates[level][i], g,
                        level * 100 + 50 + i)
            gate = torch.softmax(self.specific_gate_outs[level][i](g), dim=1)
            outs.append(torch.einsum("bn,bnd->bd", gate, cur))
        cur = torch.stack(specific + shared, dim=1)
        g = inputs[-1]
        if self.shared_gates is not None:
            g = run(self.shared_gates[level], g, level * 100 + 70)
        gate = torch.softmax(self.shared_gate_outs[level](g), dim=1)
        outs.append(torch.einsum("bn,bnd->bd", gate, cur))
        return outs

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        h = self._dnn_input(batch, feed, train=train, key=key)
        inputs = [h] * (self.num_tasks + 1)
        for lv in range(self.num_levels):
            inputs = self._cgc(inputs, lv, train, key)
        logits = []
        for i in range(self.num_tasks):
            t = inputs[i]
            if self.towers is not None:
                t = self._run(self.towers[i], t, train,
                              threefry.fold_in(key, 1000 + i))
            logits.append(self.tower_outs[i](t))
        return self._predictions(logits)


# ---------------------------------------------------------------------------
# ESMM (reference esmm.py): exactly 2 tasks, [ctr, ctr * cvr]
# ---------------------------------------------------------------------------

class ESMM(_MTLBase):
    def __init__(self, layout, *,
                 tower_dnn_hidden_units: Sequence[int] = (256, 128), **kw):
        # before the bank is drawn; a task count under 2 raises first
        if kw.get("num_tasks", 2) > 2:
            raise ValueError("the length of task_names must be equal to 2")
        super().__init__(layout, **kw)
        gen = self._take_generator()
        units = tower_dnn_hidden_units
        self.ctr_dnn = self._mlp(gen, self.input_dim, units)
        self.cvr_dnn = self._mlp(gen, self.input_dim, units)
        self.ctr_out, self.cvr_out = self._heads(gen, 2, units[-1])

    def forward(self, batch, feed=None, key=None):
        train, key = self._train_key(key)
        h = self._dnn_input(batch, feed, trans=False)
        ctr = self._run(self.ctr_dnn, h, train, key)
        cvr = self._run(self.cvr_dnn, h, train, threefry.fold_in(key, 1))
        ctr_pred = core.prediction(self.ctr_out(ctr), self.task)
        cvr_pred = core.prediction(self.cvr_out(cvr), self.task)
        # CTCVR = CTR * CVR (esmm.py:512)
        return torch.cat([ctr_pred, ctr_pred * cvr_pred], dim=-1)
