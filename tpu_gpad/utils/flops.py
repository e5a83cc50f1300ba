"""Logical flop accounting for GPAD solves (MFU denominators).

The reference's abstract gives the per-iteration flop law
``3m + ~2 n_u N m + 3 n_u N + ~2 n_u N m`` for the four explicit steps
(``Documents/ECE_5770_Final_Project_Abstract___GPAD.pdf`` p.2); here the
count depends on the iteration *form* actually executed (``core.resolve_form``)
since the dual-only form replaces the two rectangular MVPs with one square
product against the dual Hessian. Counts are LOGICAL (unpadded) multiply-add
pairs — the standard MFU numerator — so %-of-peak reflects useful work, with
kernel padding showing up as lost efficiency rather than inflated flops.
"""

from __future__ import annotations


def solve_flops(
    data, iterations: int, form: str = "dual", flat: bool = False
) -> int:
    """Flops for ONE scenario solved for ``iterations`` GPAD iterations.

    ``form`` is the resolved iteration algebra ("dual" | "mvp"); pass the
    output of ``core.resolve_form``, and ``core.resolve_flat`` for ``flat``
    (the identity-block step-4 cut, mvp form only). SAXPY/projection steps
    (O(m) per iteration) and the one-off primal recovery are included for
    honesty but are <1% of the matmul terms at every bundled size."""
    n_z = data.n_z
    if form == "dual":
        m_h = data.m_half
        per_iter = 2 * m_h * m_h + 10 * m_h  # square MVP + step1/4/s SAXPYs
        recovery = 2 * (2 * m_h * n_z)  # z and zhat reconstruction matmuls
        setup = 2 * n_z * m_h  # e = g_P @ GL_T hoisted out of the loop
        return iterations * per_iter + recovery + setup
    if form == "mvp":
        m = data.m_half if data.paired else data.m
        # two rectangular MVPs (step 2 contracts once in the paired layout,
        # step 4 applies one product with both signs) + SAXPYs; with flat,
        # step 4's identity-block columns cost one multiply per entry
        step4_cols = data.n_struct if (flat and data.paired) else m
        per_iter = (
            2 * m * n_z + 2 * n_z * step4_cols + 3 * m + 3 * n_z
            + (n_z if flat and data.paired else 0)
        )
        return iterations * per_iter
    raise ValueError(f"unknown form: {form!r}")
