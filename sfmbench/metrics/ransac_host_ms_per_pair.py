"""Host ms per pair classified spent issuing the card's RANSAC work: the
seconds of the program's spans `verify.sample`, `verify.ransac.E`, `.F`,
`.H` and `verify.pose` (waits hidden in linalg's error checks included)
over the `classified` of the window's untraced jobs
(sfmbench.program_roots). None where the program records no such
roots."""

from sfmbench import program_roots


def _issuing(name: str) -> bool:
    return name in ("verify.sample", "verify.pose") or \
        name.startswith("verify.ransac.")


def read(ctx):
    w = program_roots.window(ctx, "verify")
    if w is None:
        return None
    recs, pairs = w
    return 1e3 * sum(e["seconds"] for r in recs
                     for k, e in r["spans"].items() if _issuing(k)) / pairs
