"""The program's records of an untraced window of the sharded bundle
adjustment cell: `program_roots.window`'s rule, unedited, for the roots
`ba.sharded.solve` (`parallel/ba_sharded.solve_sharded`), picked by
their `lm_steps` against the harness's `iterations`. None where the
program keeps no such roots (a port before them).

Importing this module adds the kind `ba_sharded` to
`program_roots.KINDS`, the table of kinds that rule reads."""

from sfmbench import program_roots

KIND = "ba_sharded"
program_roots.KINDS.setdefault(
    KIND, ("ba.sharded.solve", "lm_steps", "iterations", "lm_steps"))


def window(ctx):
    return program_roots.window(ctx, KIND)


def span_seconds(recs, name: str) -> float:
    return sum(r["spans"].get(name, {}).get("seconds", 0.0) for r in recs)
