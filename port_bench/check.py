"""What decides ``correct``: every answer of the window, judged by the
configuration's plain reference against its operand rebuilt from the seed.

Each number compared has its limit, which the configuration states.
``failed`` is judged here for every cell: the requests whose answer did not
come (an exception, or a report short of its target by the program's own
account); limit 0. The rest come from the reference's ``judge(config,
records, rebuilt)``, over records with their ``index``, ``failed`` flag and
``answer`` (None where none came); ``rebuilt(record)`` gives the record's
operand and b, bit for bit as served.
"""
from __future__ import annotations


def judge(mix, records: list) -> dict:
    """``{name: (value, limit)}`` over ``records``, one per request of the
    window."""
    checks = {"failed": (sum(1 for r in records if r["failed"]), 0)}
    checks.update(mix.reference.judge(mix.config, records, mix.rebuilt))
    return checks


def passed(checks: dict) -> bool:
    return all(value <= limit for value, limit in checks.values())
