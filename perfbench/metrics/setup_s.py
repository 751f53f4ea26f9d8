"""Set-up: from the process's start to the window's start. Weights
drawn on the device, the engine built and warmed, its decode graphs
captured, the cell's decode shapes warmed, and the ramp that fills the
batch before timing starts (host clock)."""
SOURCE = 'host_clock'


def read(run):
    return run.setup_s
