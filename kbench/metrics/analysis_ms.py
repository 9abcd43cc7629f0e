"""Mean latency of the window's analyses, in ms: the program's
``AnalysisReport.analysis_seconds`` (discovery with DBSCAN, the forests
and the predictor's fit, each timed to a device synchronize)."""


def read(run: dict):
    a = run["analyses"]
    return sum(a) / len(a) * 1e3 if a else None
