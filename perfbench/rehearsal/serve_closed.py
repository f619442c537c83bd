"""The closed-loop serving driver's rehearsal on the CPU: its traffic
cut."""

#: Traffic keys set anew, so that a rehearsal takes a few seconds.
CUT = {"tenants": 8, "buckets": [1, 4], "warmup_buckets": [4], "nsteps": 10,
       "batch_window_s": 0.0}
