"""The queue's share of the requests' time (prefill cells): the host
seconds of the engine's ``serve.queued`` spans (``submit()`` to the start of
the round that admits the request) over those of its ``serve.request`` spans
(``submit()`` to the end of the ``step()`` that commits its first token),
over the requests whose first token came back while the trace recorded
(``repro_torch.tracing``).  No reading without the trace, in train cells,
without device time (the CPU) or from a program without the recorder."""


def read(r):
    if r["mode"] != "prefill" or r["summary"] is None \
            or not r["summary"].busy_s:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    queued, request = (tracing.total(n) for n in ("serve.queued",
                                                  "serve.request"))
    if queued is None or request is None or not request.host_s:
        return None
    return 100.0 * queued.host_s / request.host_s
