"""served_docs_per_s: every document of the requests due in the window
whose verdicts came, over the time from the window's start to the last of
those verdicts (open loop): the rate at which the service answers the
offered load. Below capacity it reads about the offered rate; a service
that falls behind its arrivals reads less."""


def read(rec):
    served = rec.get("served")
    if not served or not served["docs"]:
        return None
    return served["docs"] / (served["last"] - rec["window_start"])
