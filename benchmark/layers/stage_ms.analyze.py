"""Mean per cycle of the controller's own analyze stage mark,
inferno_reconcile_stage_duration_msec{stage="analyze"}, over the window."""


def read(rec: dict):
    return rec.get("stage_ms", {}).get("analyze")
