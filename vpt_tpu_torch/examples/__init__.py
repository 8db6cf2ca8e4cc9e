"""Runnable recipes of the port: ``config3_mcm256`` (BASELINE config 3
end to end)."""
