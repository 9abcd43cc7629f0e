"""Share of the window's wall time outside engine calls, trials and
analyses, in %: what the session facade, the Monitor and the Knowledge
base cost on the host, with the executor's own bookkeeping."""


def read(run: dict):
    rest = run["wall_s"] - run["engine_s"] - run["trial_s"] - \
        run["analysis_span_s"]
    return rest / run["wall_s"] * 100.0
