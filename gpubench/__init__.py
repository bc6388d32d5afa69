"""The port's benchmark: terrain jobs on DEMs made on the card(s), timed
end to end, traced by layer and checked against a plain reference.

``BENCHMARK.json`` at the checkout's root names the cells; ``run.py``
runs one (``python3 -m gpubench --workload <name> --seed <n> --seconds
<s> --trace <0|1>``); ``calibrate.py`` reads the numbers that the
correctness limits are set from.  Nothing here imports JAX or the JAX
package; the references import nothing of the port.
"""
