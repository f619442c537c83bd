"""What the models' rehearsal files share."""
from __future__ import annotations


def half_aux(aux: dict, key: str) -> dict:
    """``aux`` with the first half of its ``key`` rows alone, over half
    the volume."""
    n = aux[key].shape[0] // 2
    return dict(aux, **{key: aux[key][:n], "volume": aux["volume"] / 2})
