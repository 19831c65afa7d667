"""One reader a metric, found by the metric's name: `read(run)` returns the
metric's value from the run's timings (run.window, run.setup_s,
run.peak_bytes) or the traced run's profile (run.profile: the harness's
ranges; run.profile.spans: the port's own spans, read by
recbench.spans.span_ms), or None where there is nothing to read, and the
harness leaves the metric out."""
