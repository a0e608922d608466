"""Mean per cycle of the controller's own publish stage mark,
inferno_reconcile_stage_duration_msec{stage="publish"}, over the window."""


def read(rec: dict):
    return rec.get("stage_ms", {}).get("publish")
