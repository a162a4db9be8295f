"""seed_rounds_per_s: every lane's rounds completed in the window over the
window's whole host time (rounds a call times its lanes; a cohort's
initial rounds take time and count no round)."""


def read(run):
    return run.seed_rounds / run.window_s
