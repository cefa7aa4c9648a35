"""Training: schedules, optimizer and the train step."""
