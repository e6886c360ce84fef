"""Traffic drivers: ``drivers/<name>.py`` runs every traffic mix whose
file names it under ``"driver"``."""
