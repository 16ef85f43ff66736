"""Share of the staged path's stages that the stage cache spared over the
window: 100 x the program's counter `stage_cache.reused` (the deepest
hit's depth) over `stage_cache.stages` (the ops of each run)."""

from portbench.recorder import counter_pct


def read(run):
    return counter_pct(run, "edit", "stage_cache.reused", "stage_cache.stages")
