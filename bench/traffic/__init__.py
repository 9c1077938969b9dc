"""Traffic generators, frozen copies of the program's own draws."""
