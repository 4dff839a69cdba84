"""Models of the port (twin of ``satrans_tpu/models``): SATrans and the
single-task baseline zoo.  STAR, the multi-task models and the legacy
Star-Trans models are not ported yet.

Every model is an ``nn.Module`` on an explicit device with

* ``layout`` - its :class:`~satrans_torch.features.FeatureLayout`;
* ``forward(batch, feed=None, key=None) -> [B]`` - the predictions
  (post-sigmoid for ``task='binary'``); in training mode the dropout of
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

The JAX package's model state (BatchNorm running statistics) and
``aux_loss`` have no counterpart yet: no ported model has either.
"""

from .satrans import SATrans
from .zoo import (AFM, DCN, NFM, PNN, AdaSparse, AutoInt, DeepFM, FiBiNET,
                  WDL, XDeepFM)

# the JAX package's names (satrans_tpu/models/__init__.py:8-29) of the
# ported models
MODEL_REGISTRY = {
    "SATrans": SATrans,
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
}

__all__ = ["AFM", "AdaSparse", "AutoInt", "DCN", "DeepFM", "FiBiNET",
           "MODEL_REGISTRY", "NFM", "PNN", "SATrans", "WDL", "XDeepFM"]
