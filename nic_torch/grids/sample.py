"""Decode-graph switches shared with the trainer (part of the port of
``nic.grids.sample``; the gather-based ``decoder_input`` comes with the
training slice)."""

from __future__ import annotations

__all__ = ["effective_pe_flags", "EVEN_PARITY_CORNERS_3D"]


def effective_pe_flags(compression_method: int, ndim: int,
                       tf_use_tri_pe: bool) -> tuple[bool, bool]:
    """(use_tri_pe, sparse_g0) from the training configuration: method 4
    uses the sparse 4-corner G0 with sinusoidal PE, 3D method 3 uses
    triangular PE, otherwise ``tf_use_tri_pe`` decides."""
    sparse_g0 = compression_method == 4
    if sparse_g0:
        use_tri_pe = False
    elif ndim == 3:
        use_tri_pe = True
    else:
        use_tri_pe = bool(tf_use_tri_pe)
    return use_tri_pe, sparse_g0


# method-4 sparse G0: the four even-parity cube corners, in the reference's
# order
EVEN_PARITY_CORNERS_3D = ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0))


def _g1_weights_active(step: float, quirk: bool = True) -> bool:
    """G1 interpolation weights are applied unless ``int(1 // (step/2)) ==
    1``, i.e. they are skipped exactly when step == 2 (the reference's
    raw-sum quirk); ``quirk=False`` always applies them."""
    if not quirk:
        return True
    return int(1 // (step / 2)) != 1
