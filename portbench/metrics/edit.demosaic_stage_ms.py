"""Mean host ms of the staged path's demosaic stage (`Pipeline.stage_ms
["demosaic"]`) over the block of edits that the edit traffic replays after
the window, on a session whose stage cache keeps nothing (so every edit
runs the stage) and with the program's logger at DEBUG (so each stage ends
in a device synchronize)."""


def read(run):
    ms = [d["demosaic"] for d in run["readings"].get("stage_ms") or [] if "demosaic" in d]
    return sum(ms) / len(ms) if ms else None
