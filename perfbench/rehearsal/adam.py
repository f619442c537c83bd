"""The Adam driver's rehearsal on the CPU: its traffic cut."""

#: Traffic keys set anew, so that a rehearsal takes a few seconds.
CUT = {"nsteps": 12, "warmup_steps": 1}
