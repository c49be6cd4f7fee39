"""The least time an NVIDIA H100 SXM could take for an alignment's work.

Counted from the recurrences, once per cell that the inputs need, whatever
implements them: padding, rematerialised chunks and re-read planes add
nothing.  The rate is the card's densest integer rate, so no kernel can
beat it and no share of it can pass 100%.

Operations a cell (the Gotoh recurrence of ``reference/gotoh.py``):

* score-only PSA, ``OPS_PSA_CELL`` = 11: E = max(E + e, H + o + e) is two
  adds and a max (3); F the same (3); the substitution score, a compare
  and select (1); the diagonal add (1); H = max(diag, E, F), two maxes
  (2); the running matrix maximum (1);
* traced PSA, ``OPS_PSA_TRACED_CELL`` = 14: the above and the three
  decisions the traceback reads (which of diag, E and F made H; whether E
  and F extended or opened), one compare each (3);
* a POA round (the recurrence of ``reference/poa.py``), per cell of a
  node's row, ``OPS_POA_CELL`` = 11: substitution (1), diagonal add (1),
  C = max(diag, E) (1), F (3), H = max(C, F) (1), and the traceback's
  four decisions (H's type, E's and F's extension, the best pred) (4);
  and per pred edge of the graph and column, ``OPS_POA_EDGE`` = 5: the
  pred's E candidate max(E + e, H + o + e) (3), folding it into E (1) and
  folding the pred's H into the diagonal's max (1).

The densest integer rate: 132 SMs x 128 lanes a clock x 1.98 GHz boost
(NVIDIA H100 SXM5 data sheet: 132 SMs, 4 x 32-lane schedulers an SM),
each lane an 8-bit value packed four to a 32-bit register (the
reference TSTA's own difference method keeps 8-bit differences), each
instruction a DPX add fused with a max (two operations): ``PEAK_OPS_S``.

Bytes: each input byte read once and each output byte written once, at
the H100 SXM's 3.35 TB/s of HBM3 (``HBM_BYTES_S``).  The bound is the
larger of the two times.
"""

from __future__ import annotations

SMS, LANES_PER_SM, CLOCK_HZ = 132, 128, 1.98e9
LANES_PER_REG, OPS_PER_DPX = 4, 2
PEAK_OPS_S = SMS * LANES_PER_SM * CLOCK_HZ * LANES_PER_REG * OPS_PER_DPX
HBM_BYTES_S = 3.35e12

OPS_PSA_CELL = 11
OPS_PSA_TRACED_CELL = 14
OPS_POA_CELL = 11
OPS_POA_EDGE = 5


def least_seconds(work: dict) -> float:
    """The least seconds for ``work``: ``psa_cells``, ``psa_traced_cells``,
    ``poa_cells`` and ``poa_edge_cells`` (pred edges x read columns) as
    counted above, and ``bytes`` moved; any key may be absent."""
    ops = (OPS_PSA_CELL * work.get("psa_cells", 0)
           + OPS_PSA_TRACED_CELL * work.get("psa_traced_cells", 0)
           + OPS_POA_CELL * work.get("poa_cells", 0)
           + OPS_POA_EDGE * work.get("poa_edge_cells", 0))
    return max(ops / PEAK_OPS_S, work.get("bytes", 0) / HBM_BYTES_S)
