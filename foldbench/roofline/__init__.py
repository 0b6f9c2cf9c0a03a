"""Each kernel's count of work, from its shapes (`<kernel>.py`), and the
card's peaks (`peaks.py`). Imports nothing of the program."""
