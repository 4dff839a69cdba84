"""Models of the port (twin of ``satrans_tpu/models``): SATrans, the
single-task baseline zoo, STAR, the multi-task models and the legacy
Star-Trans models (Star_Trans, Starv2/v3/v4_Trans).

Every model is an ``nn.Module`` on an explicit device with

* ``layout`` - its :class:`~satrans_torch.features.FeatureLayout`;
* ``forward(batch, feed=None, key=None) -> [B]`` (``[B, num_tasks]``
  for a multi-task model) - the predictions (post-sigmoid for
  ``task='binary'``); in training mode the dropout of
  the threefry ``key`` (``ops/threefry.py``, default ``PRNGKey(0)``), the
  key the JAX model's ``apply`` takes as ``rng``; with ``feed`` (an
  ``embeddings.BankRowFeed``) the large bank's rows come from the feed,
  as the Trainer's sparse bank updates need;
* ``reg_loss(feed=None) -> scalar`` - the L2 term the reference
  accumulates (basemodel.py:509-535), without the large bank's term under
  a ``feed``;
* ``standard_bank_access`` - True when the large bank is read through one
  ``embed_fields`` call only, so that the sparse bank updates apply, and
  ``l2_reg_embedding``.

Model state - the JAX package's ``state`` pytree, STAR's domain
BatchNorm running statistics - is the module's buffers (in its
``state_dict``, so checkpoints carry it).  A train-mode forward updates
them in place, without gradient, exactly once; an eval-mode forward only
reads them.  The JAX package's ``aux_loss`` (the third value of its
``apply``) is a model's with ``has_aux = True``, the legacy Star-Trans
models: ``forward(..., return_aux=True)`` returns ``(pred, aux)``, and
the Trainer adds ``aux`` to the total it differentiates
(``train.losses.forward_with_aux``); Starv2's scales by the real
examples of the batch, the Trainer's 0/1 pad mask ``batch["_weight"]``.

A model that routes by a scenario column (STAR, the multi-task models
and the legacy Star-Trans models) also has

* ``domain_col`` - the column, and ``domain_id_offset``, the raw id of
  branch 0, with ``set_domain_offset(offset)``: ``Trainer.fit`` learns it
  from the data (the reference's meta_basemodel.py:218,
  mtl_basemodel.py:160), and for a multi-task model ``predict``
  re-learns it from its own data (mtl_basemodel.py:352);
* ``num_tasks`` - the count of heads (1 unless multi-task); the Trainer
  (``train.trainer.DomainRouted``) and the ``Predictor`` route a ``[B,
  num_tasks]`` output with ``train.losses.route_by_domain``.
"""

from .mtl import ESMM, MMOE, PLE, SharedBottom
from .satrans import SATrans
from .star import StarNet
from .star_trans_legacy import (StarTrans, Starv2Trans, Starv3Trans,
                                Starv4Trans)
from .zoo import (AFM, DCN, NFM, PNN, AdaSparse, AutoInt, DeepFM, FiBiNET,
                  WDL, XDeepFM)

# the JAX package's names (satrans_tpu/models/__init__.py:8-29)
MODEL_REGISTRY = {
    "SATrans": SATrans,
    "Star_Net": StarNet,
    "WDL": WDL,
    "DeepFM": DeepFM,
    "DCN": DCN,
    "xDeepFM": XDeepFM,
    "NFM": NFM,
    "AFM": AFM,
    "PNN": PNN,
    "AutoInt": AutoInt,
    "FiBiNET": FiBiNET,
    "AdaSparse": AdaSparse,
    "SharedBottom": SharedBottom,
    "MMOE": MMOE,
    "PLE": PLE,
    "ESMM": ESMM,
    "Star_Trans": StarTrans,
    "Starv2_Trans": Starv2Trans,
    "Starv3_Trans": Starv3Trans,
    "Starv4_Trans": Starv4Trans,
}

__all__ = ["AFM", "AdaSparse", "AutoInt", "DCN", "DeepFM", "ESMM", "FiBiNET",
           "MMOE", "MODEL_REGISTRY", "NFM", "PLE", "PNN", "SATrans",
           "SharedBottom", "StarNet", "StarTrans", "Starv2Trans", "Starv3Trans",
           "Starv4Trans", "WDL", "XDeepFM"]
