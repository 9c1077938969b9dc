"""One driver a kind of traffic; a cell's file names its driver."""
