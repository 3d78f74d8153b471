"""Planner data the port needs: the model zoo that shapes trained drafts."""
