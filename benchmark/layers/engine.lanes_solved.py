"""Lanes the solve engine re-solved per cycle (its inferno_solve_lanes
{state="solved"} gauge, read after each cycle), mean over the window."""


def read(rec: dict):
    return rec.get("lanes_solved")
