"""Device time of the chunked rounds' backward passes (best sink, window
remats, bounded walks) from the program's ``RoundClock``, summed over a
call's rounds, mean over the calls, in ms; None where no round chunked."""


def read(rec):
    per_call = [sum(r["backward_ms"] for r in c["rounds"] if "backward_ms" in r)
                for c in rec["calls"]
                if any("backward_ms" in r for r in c.get("rounds", []))]
    return sum(per_call) / len(per_call) if per_call else None
