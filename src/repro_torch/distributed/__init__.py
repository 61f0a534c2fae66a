"""Tensor parallelism on ``torch.distributed``: the sharding rules
(``sharding.py``), the explicit collectives (``collectives.py``) and one
process a rank (``ranks.py``)."""
