"""The brokers' CPU per delivery at a fixed host speed: the brokers' CPU
µs per delivery matched in the window (``broker_cpu_us_per_delivery``,
read from ``/proc`` through ``proctree``), times ``P_REF_US`` over the
host probe's reading over the same window (``run.probe_reading()``'s
``p_run_us``, the median wall µs its fixed unit of work took).

The card's host runs the same work faster or slower from minute to
minute, in every process at once; the probe, on the brokers' cores, runs
a fixed unit of per-frame Python, TLS encryption and loopback I/O beside
them, so the quotient takes the host's speed out of the brokers' reading.
``P_REF_US`` is the median of the probe's reading over the benchmark's
two calibration sets of ``hotshot_1k_2b.views_replay`` on the card
(PERF.md, section 2). ``BENCHMARK.json`` does not list the metric: over
seven sets of six runs of that cell on the card's host, with three sizes
of the probe's unit, the quotient spread 1.7-13.4% a set with each set's
farthest run left out, against the 5% it needs; the reader is there for a
later PR to list it once a divisor holds.

None where the brokers' trees could not be read at both ends, nothing was
matched, or the probe finished no unit in the window."""

from cdnbench.e2e import broker_cpu_us_per_delivery

P_REF_US = 2652.01


def read(run):
    raw = broker_cpu_us_per_delivery.read(run)
    probe = run.probe_reading()
    if raw is None or probe is None or probe["p_run_us"] <= 0:
        return None
    return raw * P_REF_US / probe["p_run_us"]
