"""Host ms a request in ``serve.upload``: the uint8 image's copy to the
card and its division there (``Upscaler._batch``)."""

from h100bench import spans


def read(run):
    recs = spans.records() if run.kind == "serve" and run.requests else None
    if recs is None:
        return None
    return 1e3 * spans.wall_s(recs, "serve.upload") / run.requests
