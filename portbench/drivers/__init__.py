"""One driver per kind of traffic; a traffic file names its driver."""
