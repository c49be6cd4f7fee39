"""Host time of an MSA call's rounds: each round's table preparation
(``prep_s``) and merge and toposort (``merge_s``) from the program's
``RoundClock``, summed over the call's rounds, mean over the calls, in
ms."""


def read(rec):
    per_call = [sum(r["prep_s"] + r["merge_s"] for r in c["rounds"])
                for c in rec["calls"] if c.get("rounds")]
    return 1e3 * sum(per_call) / len(per_call) if per_call else None
